#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``determined_tpu_torch``).

Run from the root of a checkout, on a machine with one CUDA card (an
H100; the kernels are built for ``sm_90a``)::

    python3 chip_smoke.py

Phases, each printing one line of numbers; any failure raises and the
script exits non-zero without the final result line:

1. device — refuse to run without CUDA; print the card's name and power
   limit; disable TF32 so fp32 means fp32.
2. build  — compile the seven CUDA kernels from ``determined_tpu_torch/
   ops/csrc`` with nvcc (one process per source, started together).
3. kernels — each kernel against its plain PyTorch version on the same
   inputs, in bf16 (o and gradients atol/rtol 2e-2, lse atol 1e-3) and
   fp32 (atol 1e-5; the mono and fused blocked backward sum dq with fp32
   atomics in no fixed order, hence also rtol 1e-5 for every backward);
   kernel, plain and library (SDPA) times with the bound (max of FLOPs /
   peak and bytes / 3.35 TB/s), the TFLOP/s on live pairs and the share
   of the bound. The flash forward is held against its own plain version
   (``flash_fwd_plain``, p rounded to bf16 where the kernel rounds it)
   and against the entry point's plain path
   (``flash_attention_lse_plain``). The flash forward and paged kernels
   run at the serving shapes, the paged kernel also at 32 slots of 8 full
   pages (where bytes, not latency, set its time; two paged launches must
   agree bit for bit); the mono pair at (B 2, S 1024, causal), (B
   2, S 512, non-causal) and with a nonzero lse cotangent, then over
   ``MONO_GRID`` (the cases its persistent wgmma/TMA design makes risky:
   ragged tiles, s_q ≠ s_k causal and full, misaligned views, fewer work
   items than SMs and many more, s = 1448, no queries, no keys) at head
   dims 16/32/64/128 in both dtypes, and is timed at the train phase's
   shape (B 8, S 1024, H 12, D 64, causal, bf16) against SDPA's forward
   and, on a retained graph, SDPA's backward alone, and beside the
   blocked sm90 kernels (``flash_fwd``, ``flash_bwd_blocked``) on the
   same inputs; the backward wrapper's zeroing of its fp32 dq workspace
   and its cast are timed alone too. The blocked backward kernels — the
   fused ``flash_bwd_blocked`` and the two-pass ``flash_bwd_dq`` +
   ``flash_bwd_dkv`` — run
   ``BLOCKED_CASES`` (causal at S 2048, a 256 window, packed segments,
   kv_offset with s_q 512 and s_k 1024, a nonzero lse cotangent, all of
   them at once; two dq launches and two dk/dv launches must each agree
   bit for bit), then the shapes the main paths give them, in bf16: the
   packed phase's batch (B 8 × 1024, its ``pack_sequences`` segment ids;
   ``flash_fwd`` too; both timed), and the long-context shapes (B 1, H
   12, D 64, causal): ``flash_fwd`` and the fused kernel at S 16384
   against SDPA, the two passes and the fused kernel at S 32768. At the
   long shapes the plain versions run one head at a time (one [S, S]
   fp32 matrix per call); each kernel is held against it and timed
   beside it on the same inputs, and both once more at S ``PLAIN_SEQ`` =
   4096, where ``flash_bwd_dq`` is also held against the plain copy of
   its own tile walk (``_bwd_dq_walk_plain``: the same ds roundings and
   the same fp32 summation order by tile) at bf16 atol 2e-3 and rtol
   2^-7 (one bf16 ulp; the 2e-2 of the other bf16 checks would pass an
   error ten times larger). At S 32768 one more line, ``route-32k``, times
   the two routes past the partials cap on the same inputs: the fused
   kernel against the dq and dk/dv passes back to back. The
   ``max_abs_err`` of rows 4–6 in the kernels line comes from these
   main-path shapes; every row names its ``shape``.
4. engine — GPT-2-small at full width (bf16, seeded random weights)
   behind ``build_engine``: 8 requests, then 4 late joiners while the
   first are mid-decode; every request must finish with reason
   ``length``, every page must come back, and the launch counters must
   show 12 flash launches per prefill and 12 paged launches per decode
   iteration.
5. greedy — the same engine at fp32 on the paged kernel, then with
   ``DTPU_PAGED_ATTN=0`` (gather → flash kernel), 4 requests each: one
   full-context ``apply`` over prompt + generated must argmax-predict
   every emitted token except where its top-2 margin is below 1e-4, and
   the two kernels' streams must agree up to the first such near-tie.
6. train — GPT-2-small at full width and depth, bf16 over fp32 master
   parameters, ``remat=False``, batch 8 × seq 1024 of one seeded batch,
   through ``Trainer(trial).fit(max_length=Batch(7),
   report_period=Batch(1))`` under ``chain(clip_by_global_norm(1.0),
   adamw(3e-4))``: every loss finite, the last below the first, and per
   step exactly 12 ``flash_fwd_mono`` and 12 ``flash_bwd_mono`` launches
   and no ``flash_fwd`` launch; median step ms after two warm-up steps,
   tokens/s, MFU (``train_flops_per_token`` against 989 TFLOP/s bf16
   dense) and peak device memory.
7. train-parity — one fp32 loss + gradient of GPT-2-small's width with 2
   layers, batch 1 × seq 1024, from the same parameters, on the card
   (the kernels) and on the CPU (the plain path): loss within 1e-5
   relative, grad_norm within 1e-4 relative, and every gradient leaf
   within 1e-4 of its own largest magnitude (fp32 on both sides; the
   sums run in other orders — cuBLAS, the kernels' tiles and fp32
   atomics against the CPU's — which moves results by ~1e-6 relative; a
   wrong mask, scale or missing term moves them by O(1)). Three times:
   plain tokens through the mono pair; a packed batch with
   ``attn_window=256`` through ``flash_fwd`` and ``flash_bwd_blocked``;
   the same with the partials cap at 0 through ``flash_bwd_dq`` and
   ``flash_bwd_dkv``.
8. train-long — the long-context rung (``trainer/profile.py``
   ``RUNGS["long16k"]``: GPT-2-small at full width and depth, seq 16384,
   batch 1, ``remat=True``, ``fused_loss=True``) for 3 steps: losses
   finite and falling, per step exactly 12 ``flash_fwd`` and 12
   ``flash_bwd_blocked`` launches and no other port kernel; step ms,
   tokens/s, MFU, peak memory.
9. train-32k — the long32k rung (``RUNGS["long32k"]``) as it stands:
   GPT-2-small at full width and depth (12 layers), seq 32768, batch 1,
   2 steps: losses finite and falling; rematted attention
   (``layer_loop="auto"`` past 16384 tokens), so per step 2
   ``flash_fwd`` launches per layer (the forward and its recompute) and
   one ``flash_bwd_dq`` and one ``flash_bwd_dkv`` per layer, nothing
   else.
10. train-packed — ``gpt.small()`` at B 8 × 1024 on one repeated
   ``pack_sequences`` batch of seeded random documents of 32–1024
   tokens, 5 steps: the loss falls, per step 12 ``flash_fwd`` and 12
   ``flash_bwd_blocked`` launches and no mono launch.
11. checkpoint — the train phase's trial (GPT-2-small, bf16 over fp32
   masters, B 8 × 1024): run A, ``core.init(checkpoint_storage=<tmp>)``
   and ``fit(max_length=Batch(4), checkpoint_period=Batch(2))``, saves at
   steps 2 and 4 in the reference's format; run B, a fresh ``Trainer``,
   resumes with ``fit(max_length=Batch(4), latest_checkpoint=<step 2>)``.
   The state restored at step 2 (step, every parameter, every ``mu``,
   ``nu`` and ``count``) must equal the step-2 snapshot bit for bit; run
   B's losses at steps 3–4 run A's within 1e-3 relative (the mono
   backward sums dq by fp32 atomics, so bf16 steps do not repeat bit for
   bit); per step 12 ``flash_fwd_mono`` and 12 ``flash_bwd_mono``
   launches. Prints the checkpoint's bytes and files, the host-blocking
   snapshot, the background write + upload, and the restore's verify and
   load, in ms and GB/s. Then run A's step-4 parameters, saved as a
   parameter-only checkpoint, are served at fp32 through
   ``build_engine`` with ``DTPU_SERVING_CHECKPOINT``: 4 greedy requests
   must stream exactly what an engine built in memory from the same
   arrays streams. The checkpoints (~1.5 GB each) live in a temporary
   directory, removed at the end of the phase.
12. fixture — ``serving.fixture.ensure_fixture(<tmp>)`` on the card: it
   trains the fixture (300 steps, the mono pair at fp32 and seq 64, 2
   launches of each a step), whose final loss must be ≤ 0.05; a second
   call must load it without training; then ``{"model": "fixture"}`` is
   served from its directory: the greedy continuation (20 tokens) of
   each of the 12 phrases, prompted with the phrase twice, must follow
   the phrase's cycle in ≥ 95% of tokens, through ``flash_fwd`` and
   ``paged_attention``.
13. serving-http — the reference bench's serving rung
   (``SERVING_HTTP_CFG``: GPT-2-small bf16, seeded, 129 pages × 128, 8
   slots, prefill 4 × 512) behind ``GenerationServer`` on 127.0.0.1,
   driven by ``loadgen.drive`` over ``zipf_prefix_prompts(16,
   corpus_size=4, prefix_len=256, suffix_len=16, seed=7)`` at
   concurrency 8 and 32 new tokens, twice over the same list: cache off +
   spec off, then cache on + spec ngram (draft 4, min match 2). Prints
   tokens/s, TTFT p50 and p99, hit rate, proposed and accepted drafts,
   the median decode iteration, and the launches of ``flash_fwd`` at the
   cached-tail geometry (B 4, s_q 512, s_k 1536, kv_offset 1024) and of
   ``paged_attention`` at 5 query rows. Every request ends with
   ``length`` and 32 tokens, every page is back after ``flush()``, and
   the second pass hits the cache, proposes drafts and launches both
   kernels at those geometries.
14. serving-parity — fp32 (TF32 off): GPT-2-small greedy streams of 6 of
   those prompts × 16 tokens (in two waves, so the second hits the
   cache) under cache off / spec off, cache on / spec off and cache on /
   spec on, on the paged kernel and with ``DTPU_PAGED_ATTN=0``: every
   emitted token is the full-context argmax of ``apply`` except at a
   near-tie (top-2 margin < 1e-4), and all six configurations stream the
   same tokens up to the first near-tie; ``flash_fwd`` must have run at
   the cached-tail and the speculative gather geometry and
   ``paged_attention`` at 5 query rows; then the pre-trained fixture
   (trained anew in a temporary directory) on
   ``corpus_ngram_prompts(8, fixture_phrases(), seed=7)``: spec on
   streams exactly what spec off streams, with drafts accepted.
15. train-health — the train phase's trial (GPT-2-small, bf16 over fp32
   masters, B 8 × 1024) on an indexed stream (batch i from seed 1000 +
   i mod 4, O(1) ``skip``, every index recorded) under
   ``health=TRAIN_HEALTH`` (``max_consecutive_skips`` 2, ``spike_zscore``
   6, ``spike_min_history`` 4), ``checkpoint_period=Batch(4)``,
   ``report_period=Batch(1)``, ``profiling=True`` and a temporary
   ``tensorboard_dir``. Non-finite drill: ``fit`` to step 8, then to 16
   with ``train.nonfinite`` ``failures=2``: two skipped steps, one
   rollback to the step-8 checkpoint (the restored state bitwise the
   step-8 state), ``_data_offset`` 2, the recorder 0..17 (indices 8 and
   9 poisoned, steps 9–16 on 10..17). Spike drill: to 24 with
   ``train.spike`` ``failures=1``: the ×1e6 step applied and reported,
   a second rollback, ``_data_offset`` 3. Every report finite, the last
   loss below the first, per step (poisoned and spiked ones too) 12
   ``flash_fwd_mono`` and 12 ``flash_bwd_mono`` launches and nothing
   else. The ``profiling`` group carries the phase fractions (summing to
   1 within 1e-6), 0 < ``goodput_pct`` < 100, ``rollback_lost_s`` > 0,
   ``step_flops`` and, from the profiler agent, ``device0_bytes_in_use``
   above the parameters and Adam state (1.49 GB); the tfevents file,
   read back with ``read_scalars``, holds every reported loss and is
   synced to checkpoint storage; a fresh ``Trainer`` resuming the final
   checkpoint trains on index 27 with ``ledger_restarts`` 1. Prints each
   rollback restore's blocking ms (verify + load), then the median step
   ms with the sentinel, timeline, profiler agent and TensorBoard all on
   and all off (``DTPU_TIMELINE=0``, default health, no profiling) over
   ``HEALTH_COST_ROUNDS`` interleaved rounds of ``HEALTH_COST_STEPS``.

16. exec — the exec layer off the cluster, launched as the agent
   launches a trial (``DTPU_*`` trial variables, no master, no
   ``DTPU_JAX_PLATFORM``: the card). ``harness.run`` in process of the
   built-in ``SyntheticTrial`` with ``model: gpt2-small``, B 8 × 1024,
   8 batches (``searcher.max_length``), a checkpoint every 4, a report
   every batch, shared_fs storage in a temporary directory: exit 0, per
   step exactly 12 ``flash_fwd_mono`` and 12 ``flash_bwd_mono`` and no
   other kernel, checkpoints at 4 and 8 with their manifests (the step-8
   one verified); then resumed from the step-4 checkpoint through
   ``DTPU_LATEST_CHECKPOINT``: exit 0, losses of steps 5–8 within 1e-3
   relative of the first run's. Prints the median step ms read from the
   tfevents the harness wrote (steps 3–8 without 5, whose window holds
   the step-4 save) beside the same trial's through ``Trainer.fit``
   directly (same steps) and phase 6's. Then ``GPT2PretrainTrial``
   (``gpt.small()``) over two 4M-token uint16 shards from
   ``write_token_shard`` on the native loader, 6 batches: finite
   losses, the mono pair on every step; the loader's batches/s alone
   (200 batches) beside the step rate. ``LearnableTrial`` (mnist-mlp,
   60 batches: the loss falls by a quarter) and ``SyntheticTrial``
   cifar-cnn (4 batches, finite), neither launching a port kernel.
   Last, ``python -m determined_tpu_torch.exec.harness`` with
   ``DTPU_ENTRYPOINT``: mnist-mlp exits 0 (its wall s printed),
   ``CrashingTrial`` exits 1 with its message on stderr.
17. cluster — the exec layer on the cluster, against ``StandInMaster``
   (the master's routes for a trial and a serving replica, on
   127.0.0.1; the card's machine cannot run the reference master). The
   trial: ``python -m determined_tpu_torch.exec.harness`` in a
   subprocess (through ``COUNTING_BOOT``, which runs the module as
   ``-m`` does and writes its launch counts and per-step counts at exit)
   with the variables the agent sets — ``DTPU_MASTER``, the allocation,
   task and trial variables, ``DTPU_SESSION_TOKEN``,
   ``DTPU_TRACEPARENT``, ``DTPU_PROFILE=1``, ``DTPU_LOG_SHIP=1``,
   shared_fs storage — running ``SyntheticTrial`` gpt2-small B 8 × 1024
   on a searcher operation of 12 batches with a checkpoint every 4. The
   stand-in hands a profile-capture directive to the step-4 heartbeat
   (one traced step) and sets the preemption signal at the step-8
   heartbeat: the trial
   saves, acknowledges and exits 0; relaunched with
   ``DTPU_LATEST_CHECKPOINT`` = the checkpoint it registered, it
   finishes at 12, posts ``searcher/completed`` and exits 0. Held: the
   training metrics of every step 1–12, exactly once; the registered
   checkpoints verify on disk; the losses within 1e-3 relative of the
   same trial run uninterrupted off the cluster in this process (no
   checkpoints; the replica below starts meanwhile); per
   step exactly 12 ``flash_fwd_mono`` and 12 ``flash_bwd_mono`` and no
   other kernel; ``trial.run`` → ``trial.fit`` → ``trial.first_step``
   spans of both launches under ``DTPU_TRACEPARENT``'s trace; profile
   windows tagged ``step`` and ``checkpoint``; one uploaded
   ``torch.profiler`` trace and its ``complete`` POST; shipped log lines
   carrying the trace id; the bearer token on every request and an
   ``X-Request-Id`` on every POST. The replica: ``python -m
   determined_tpu_torch.serving.service`` the same way with
   ``DTPU_SERVING_CONFIG`` = phase 13's cache-off rung (GPT-2-small
   bf16), found through its proxy registration and driven by
   ``loadgen.drive`` over phase 13's prompts with a ``traceparent`` on
   each request: every request's ``serving.request`` span with its
   ``serving.queue``, ``serving.prefill`` and ``serving.decode`` children
   under the client's trace; then the preemption signal, and the replica
   drains and exits 0. Prints the cluster path's median step ms beside
   phase 16's off-cluster one and the replica's tokens/s beside phase
   13's.

18. mesh — training on a ``data × fsdp`` device mesh (``parallel``,
   ``trainer/_mesh.py``). One rank over NCCL (``init_process_group`` at
   127.0.0.1, world 1): phase 6's trial (GPT-2-small, bf16 over fp32
   masters, B 8 × 1024) through ``Trainer(mesh=make_mesh(MeshConfig(
   data=1, fsdp=1)))`` for ``MESH_STEPS`` steps with the audit every 2
   steps (run at 2, 4 and 6) and a sharded save at ``MESH_SAVE_AT``:
   every loss within 1e-3 relative of phase 6's, per step 12
   ``flash_fwd_mono`` and 12 ``flash_bwd_mono`` launches and no
   ``flash_fwd``; a fresh trainer restores the step-4 checkpoint to the
   saved state bit for bit; with one copy of every block the
   ``train.divergence.rank0`` drill has nothing to disagree with (as the
   reference on one device). Then phase 10's packed batch on the same
   mesh: losses within 1e-3 of phase 10's, 12 ``flash_fwd`` and 12
   ``flash_bwd_blocked`` a step. Then two ranks on the one card at
   ``fsdp=2`` over gloo, each a subprocess (``MESH_RANK``) training
   phase 6's trial for ``MESH_GANG_STEPS`` steps on its 4 rows with the
   audit every step: both ranks report the same losses, within 1e-3 of
   the one rank's, 12 + 12 mono launches a step, and the drill on rank 0
   raises ``ReplicaDivergenceError`` naming rank 0 on both ranks (two
   holders: no majority, both named). At fsdp=2 the state is ZeRO-3's:
   a rank's model holds its parameter blocks alone, each layer's weights
   gathered at use (``trainer/_mesh.py``), and its grad norms are held
   against the one rank's at ``GRAD_NORM_RTOL``. Prints both step times,
   the peak memory and the state's resident bytes of one rank and of each
   of the two: ``state_gb`` the model's parameters (the blocks), the
   trainer's parameter tensors that are not theirs and the AdamW moments
   (each storage once), ``split_gb`` the last two alone; and the gang's
   all-gathers and reduce-scatters and their MB a step.

19. context — training over the context axis (``parallel/ring.py``,
   ``parallel/ulysses.py``, ``trainer/_mesh.py``): two ranks on the one
   card over gloo as subprocesses (``CONTEXT_RANK``), ``MeshConfig(data=1,
   context=2)``, GPT-2-small at full width and depth, bf16 over fp32, the
   runs of ``CONTEXT_RUNS``: B 8 × 1024 through the ring (the mono pair)
   and through Ulysses (dense local attention, no kernel), phase
   train-packed's batch with ``attn_window=256`` through the ring
   (``flash_fwd`` with ``kv_offset`` and segments, the fused blocked
   backward), the long16k rung through the contiguous ring and through
   the zigzag loader (``TokenDataset(zigzag_ring=2)`` over a shard of the
   rung's tokens and one more, whose target is masked), the long32k rung
   (the fused blocked backward: its hops' dq partials fit the cap) and
   the long32k rung's fields at seq 65536 (the two-pass backward). Every
   loss within 1e-3 relative of the one-device run of the same trial
   (phases train, train-long, train-32k; the packed window run and the
   64k run are made here first), both ranks alike, and per step and rank
   exactly the flash launches of the hops that rank attends. Prints per
   run each rank's step ms and peak memory, the ring's rotations and
   bytes a step, the collectives a step and the transport (the ring's
   K/V staged through pinned host buffers: gloo's send and receive take
   host memory only).

20. tensor — training over the tensor axis (``parallel/tensor.py``,
   ``models/gpt.py``'s slices, ``trainer/_mesh.py``): gangs on the one
   card over gloo as subprocesses (``TENSOR_RANK``), GPT-2-small at full
   width and depth, bf16 over fp32, the headline trial's seeded weights
   carried in by ``load_jax_params``' numpy path, the runs of
   ``TENSOR_RUNS``: two ranks at ``MeshConfig(data=1, tensor=2)``, B 8 ×
   1024 (the mono pair at 6 heads a rank) with a sharded save at step 2
   and the audit every step, and phase train-packed's batch with
   ``attn_window=256`` (``flash_fwd`` and the fused blocked backward);
   four ranks at ``context=2 × tensor=2``, B 8 × 1024 by ring and by
   Ulysses. Every loss within 1e-3 relative and every grad norm within
   ``GRAD_NORM_RTOL`` of the one-device run (phase train; phase
   context's packed window run), every rank alike; per step
   and rank exactly the flash launches of its heads; each rank's
   resident state below phase mesh's one rank's; the save's files in
   the reference's names with the tensor offsets, a fresh gang's
   restore bit for bit and its losses on equal to the uninterrupted
   run's. Prints per run each rank's step ms, peak memory and state, and
   the collectives a step by group with their bytes. First the
   deterministic pair (``TWO_PASS_RUNS``): the headline trial at blocks
   512 with the fused backward's partials cap at 0 in every process, so
   each layer runs ``flash_fwd`` and the dq and dk/dv passes (no fp32
   atomics): 3 steps on one device twice, whose losses and grad norms
   must repeat bit for bit, and at ``tensor=2``, held to them on every
   step (losses 1e-3, grad norms ``GRAD_NORM_RTOL``); the mono
   ``headline-t2`` run's grad norms are then held on its first two steps
   (``TENSOR_NORM_STEPS``: its step 3 is the spike, where the mono
   backward's atomics scatter the reading from call to call).

22. experts — the top-1 mixture of experts (``parallel/experts.py``,
   ``models/gpt.py _moe_mlp``): GPT-2-small with an expert MLP in every
   block in Switch-Base-8's arrangement (``EXPERT_FIELDS``: 8 experts,
   capacity 1.25; 521 M parameters), the headline trial. ``EXPERT_STEPS``
   steps on one device through the index dispatch, held against the same
   run through the dense one-hot einsums (the plain version): the first
   loss bit for bit and the first grad norm within 1e-3, the losses
   within 1e-3, 12 + 12 mono launches a step. Then the gangs of
   ``EXPERT_GANGS`` over gloo (``TENSOR_RANK``): two ranks at
   ``expert=2``, four at ``expert=2 × tensor=2`` (the experts' ``mlp``
   dimension split, 12 + 12 mono launches at 6 heads a step) and four at
   ``expert=2 × context=2`` by the ring (i + 1 hops a layer on context
   rank i): every loss within 1e-3 of the one-device run and the first
   ``EXPERT_NORM_STEPS`` grad norms within ``GRAD_NORM_RTOL`` (later ones
   part as bf16 rounding flips routing decisions; the tensor and context
   splits change the forward's rounding, so they flip it at step 1 and
   hold ``SPLIT_NORM_STEPS``), every rank alike, a
   rank's resident state below one device's (below ``expert=2``'s with
   the tensor split), the saves at ``EXPERT_SAVE_AT`` (the experts' and
   the ``mlp`` offsets in the names) restored bit for bit by a fresh gang
   and onto one rank on the card, which trains on within 1e-3 of the
   gang; each layer's dropped share at step 1 printed beside the one
   device's. Then the fp32 twins of the two split gangs
   (``EXPERT_FP32_TWINS``: the same gangs in fp32 at 2 layers, every
   expert kept) against a one-device fp32 run at that depth: every loss
   within ``FP32_LOSS_RTOL`` (1e-5) and the first ``EXPERT_NORM_STEPS``
   grad norms within ``FP32_NORM_RTOL`` (1e-4) relative, each step's
   dropped share printed beside the one device's. Then a greedy decode of ``EXPERT_TOKENS`` tokens for 4
   prompts through ``GenerationEngine`` (``flash_fwd`` prefill, paged
   decode): the index dispatch's streams are the dense dispatch's. Prints
   each layer's share of dropped tokens.

23. pipeline — pipeline stages (``parallel/pipeline.py``, the pipelined
   ``GPT``): gangs on the one card over gloo (``TENSOR_RANK``), the runs
   of ``PIPELINE_RUNS``: ``pipeline=2`` by GPipe, circular (V 2) and 1F1B
   at M 4, ``pipeline=4`` 1F1B at M 8, ``pipeline=2 × tensor=2`` 1F1B and
   ``pipeline=2 × context=2`` 1F1B through the ring on the Trainer's
   pre-shifted batch. Every loss within 1e-3 relative and the first
   ``PIPELINE_NORM_STEPS`` grad norms within ``GRAD_NORM_RTOL`` of phase
   train's (a stage rounds its bf16 weight gradients per microbatch,
   which the one-device run's step-3 spike magnifies), every rank alike;
   per step
   and rank the mono launches of the schedule (the stage's L/S layers × M,
   the forward twice under 1F1B, i + 1 calls a layer on context rank i)
   and the 1F1B stash's high-water mark, at most min(M, 2S − 1). Prints
   per step and rank the step's wall time, and each rank's resident state,
   peak memory and point-to-point MB a step.

24. zoo — the generative pair (``models/generative.py``,
   ``examples/generative_trials.py``): ``DiffusionTrial`` and
   ``DCGANTrial`` through ``harness.run`` at the hyperparameters of the
   repo's ``examples/diffusion.json`` and ``dcgan.json`` (32 × 32, 1
   channel, batch 64, 200 timesteps, lr 2e-4), ``ZOO_STEPS`` steps on one
   rank with shared-fs storage (cut: the examples' ``data: 8`` mesh and
   ``gcs`` storage) and a save at ``ZOO_SAVE_AT``: finite losses, the
   DDPM's falling; the save restored bit for bit, the run resumed from it
   within 1e-3; 16 DDPM samples over 200 steps finite; at fixed
   parameters and draws the card's fp32 loss within 1e-4 relative of the
   port's CPU run, and in fp64 on both sides the loss and the whole
   gradient (L2) (TF32 off; the fp32 gradient's difference printed: at a
   ReLU kink fp32 rounding picks the slope). Prints the step ms and the
   sample's
   seconds. No port kernel runs: the convolutions are cuDNN's, as the
   reference's are XLA's.

25. autotune — ``ops/flash_autotune.py`` with its cache in a temp dir:
   ``tune_flash_blocks`` at B 8 × 1024, the same packed, and B 1 × 16384
   (H 12, D 64, causal, bf16), one probe a distinct route (forward
   kernel, backward route), four launches of the route's kernels each;
   each candidate's route and ms printed, the first candidate of the
   fastest route returned; a second call launches nothing. GPT-2-small
   with ``flash_autotune`` resolves its blocks from the cache when it is
   built and launches the winner's route once a layer a step;
   ``tune_paged_block_h`` returns the default and launches nothing.

26. integrations — ``transformers``' presence printed first; the haiku
   slot's trials (``HaikuVisionTrial`` conv and mlp, two DARTS
   genotypes), and where ``transformers`` imports, ``HFTrial`` at
   GPT-2-small (B 16 × 512, bf16) and ``HFClassifierTrial`` at BERT-base
   (B 32 × 128): ``INTEGRATION_STEPS`` Trainer steps, finite losses (the
   HF ones, on one repeated batch, falling), no port kernel launched;
   each trained model's fp32 logits against the port's CPU model with
   the same parameters within ``LOGIT_RTOL`` of the largest.

Phase 3 also holds ``flash_fwd`` at the cached-tail geometry (separate
query and key segment ids as ``_prefill_cached`` builds them, one row all
padding) and at the speculative gather verify's (B 8, s_q 5, s_k 1029,
kv_offset 1024, dead rows in query segment 2), ``paged_attention`` at
5 and 9 query rows with ragged ``q_lens``, in both dtypes, and the ring
hops of phase 19 (``hop_case``, bf16 with an lse cotangent): S_local
8192 causal and full, the zigzag half chunks, S_local 16384 and 32768
full (the fused and the two-pass backward), the window hop at kv_offset
512 with segments, and the mono pair at B 8 × 512 causal and full;
and phase 20's shapes at 6 heads: the mono pair at B 8 × 1024, the
packed window's ``flash_fwd`` and fused backward, the ring's mono hops
at B 8 × 512; phase 20's deterministic pair: ``flash_fwd`` and the dq
and dk/dv passes at B 8 × 1024 causal at 12 and 6 heads (no lse
cotangent); and phase 23's microbatches: the mono pair at B 2 and 1 ×
1024, at B 2 with 6 heads, and the ring's mono hops at B 2 × 512.

The last lines are the whole run's seconds, the kernels' JSON record
(each kernel's ``launches`` summed over the main paths that run it:
phases 4, 6, 8, 9 and 11 to 25), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
CLUSTER_STEPS = 12    # the cluster phase's searcher operation
#: ``python -c COUNTING_BOOT <module> <out.json> <args...>`` runs
#: ``<module>`` as ``python -m <module> <args...>`` does and, at exit,
#: writes the process's kernel launch counts, the trainer's per-step
#: counts (with the rendezvous generation of each step) and the seconds
#: of each checkpoint restore to ``<out.json>`` (the counts live in that
#: process). SIGUSR1 dumps every thread's Python stack to its stderr
#: (``Smoke.wait_or_dump``).
COUNTING_BOOT = """
import atexit, faulthandler, json, os, runpy, signal, sys, time
faulthandler.register(signal.SIGUSR1, all_threads=True)
module, out = sys.argv[1], sys.argv[2]
sys.argv = [module] + sys.argv[3:]
from determined_tpu_torch.ops import _build
from determined_tpu_torch.trainer import Trainer
per_step, generations, restores = [], [], []
step_fn, restore_fn = Trainer._train_step, Trainer._restore_with_fallback
def counted(trainer, batch, poison=1.0):
    before = {n: k.launches for n, k in _build.KERNELS.items()}
    result = step_fn(trainer, batch, poison)
    per_step.append({n: k.launches - before[n]
                     for n, k in _build.KERNELS.items()})
    generations.append(int(os.environ.get("DTPU_ALLOC_GENERATION", "0")))
    return result
def timed_restore(trainer, storage_id):
    t0 = time.perf_counter()
    restore_fn(trainer, storage_id)
    restores.append(time.perf_counter() - t0)
Trainer._train_step = counted
Trainer._restore_with_fallback = timed_restore
def dump():
    with open(out, "w") as f:
        json.dump({"launches": {n: k.launches
                                for n, k in _build.KERNELS.items()},
                   "per_step": per_step, "generations": generations,
                   "restores": restores}, f)
atexit.register(dump)
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""
MESH_STEPS = 7        # phase mesh, one rank: phase train's length
MESH_SAVE_AT = 4      # ... with a sharded save at this step
MESH_GANG_STEPS = 3   # phase mesh, two ranks on the one card over gloo
#: ``python -c MESH_RANK <rank> <port> <out.json>``: one rank of a gang of
#: two on the one card, joined over gloo at 127.0.0.1:<port>: the headline
#: trial on an fsdp=2 mesh (ZeRO-3: the model's parameters are the rank's
#: blocks, gathered at use) for MESH_GANG_STEPS steps with the audit every
#: step, its losses and grad norms, per-step launches, peak memory and
#: state bytes (``state_gb`` and ``split_gb``, as the phase counts them),
#: then the ``train.divergence.rank0`` drill.
MESH_RANK = """
import datetime, json, os, sys, time
import torch, torch.distributed as dist
rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
steps = int(sys.argv[4])
torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=300))
from determined_tpu_torch import core
from determined_tpu_torch.common import faults
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.ops import _build
from determined_tpu_torch.parallel import MeshConfig, make_mesh
from determined_tpu_torch.trainer import Batch, Trainer
from determined_tpu_torch.trainer._sentinel import ReplicaDivergenceError
from determined_tpu_torch.trainer.profile import RepeatedBatchTrial
dctx = DistributedContext(rank=rank, size=2)
mesh = make_mesh(MeshConfig(data=1, fsdp=2))
torch.cuda.reset_peak_memory_stats()
trainer = Trainer(RepeatedBatchTrial(8, 1024), core._dummy_init(
    distributed=dctx), mesh=mesh, health={"divergence_check_period": 1})
per_step, seen, audits = [], [], []
calls, nbytes, in_step = {}, {}, [False]
step_fn, flush, audit = (trainer._train_step, trainer._flush,
                         trainer._divergence_audit)
def counting(name, real):
    def call(*args, **kw):
        if in_step[0]:
            t = args[1] if name == "reduce_scatter_tensor" else args[0]
            calls[name] = calls.get(name, 0) + 1
            nbytes[name] = nbytes.get(name, 0) + t.numel() * t.element_size()
        return real(*args, **kw)
    return call
for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "broadcast"):
    setattr(dist, name, counting(name, getattr(dist, name)))
def counted(batch, poison=1.0):
    before = {n: k.launches for n, k in _build.KERNELS.items()}
    in_step[0] = True
    try:
        result = step_fn(batch, poison)
    finally:
        in_step[0] = False
    per_step.append({n: k.launches - before[n]
                     for n, k in _build.KERNELS.items()})
    return result
def recording(pending, t_start):
    agg, reason = flush(pending, t_start)
    seen.append(agg)
    return agg, reason
def audited():
    audits.append(trainer.steps_completed)
    audit()
trainer._train_step, trainer._flush = counted, recording
trainer._divergence_audit = audited
trainer.fit(max_length=Batch(steps), report_period=Batch(1))
torch.cuda.synchronize()
working = list(trainer.model.parameters())
split = [t for t in trainer._params
         if all(t.data_ptr() != w.data_ptr() for w in working)]
split += [t for s in trainer._opt_state[1][0][1:] for t in s]
gb = lambda ts: sum(t.numel() * t.element_size() for t in ts) / 1e9
res = dict(rank=rank, losses=[m["loss"] for m in seen],
           grad_norms=[m["grad_norm"] for m in seen],
           step_ms=[1e3 / m["batches_per_second"] for m in seen],
           per_step=per_step, audits=audits,
           peak_gb=torch.cuda.max_memory_allocated() / 1e9,
           state_gb=gb(working) + gb(split), split_gb=gb(split),
           collectives_per_step={k: v // steps for k, v in calls.items()},
           collective_mb_per_step={k: round(v / steps / 1e6, 3)
                                   for k, v in nbytes.items()})
os.environ["DTPU_FAULT_PLAN"] = json.dumps(
    {"train.divergence.rank0": {"failures": 1}})
faults.clear()
try:
    audit()
    res["drill"] = None
except ReplicaDivergenceError as e:
    res["drill"] = str(e)
with open(out, "w") as f:
    json.dump(res, f)
dctx.close()
dist.destroy_process_group()
"""
#: phase context: the runs, each on two ranks of the one card over gloo at
#: ``MeshConfig(data=1, context=2)`` (GPT-2-small, full width and depth,
#: bf16 over fp32): name → (rung of ``trainer/profile.RUNGS``, batch, seq,
#: steps, data ("tokens": the rung's repeated batch, "packed": phase
#: train-packed's batch, "zigzag": the zigzag loader over a shard of the
#: rung's tokens), GPTConfig fields, flash calls a layer on rank r
#: (forward), the kernels of those calls (forward, backward), forwards a
#: call and step (2 with rematted attention)).
CONTEXT_RUNS = {
    "headline-ring": ("headline", 8, 1024, 3, "tokens", {},
                      "contiguous", ("flash_fwd_mono", "flash_bwd_mono"), 1),
    "headline-ulysses": ("headline", 8, 1024, 3, "tokens",
                         {"attn_impl": "ulysses"}, "none", (), 1),
    "packed-window-ring": ("headline", 8, 1024, 3, "packed",
                           {"attn_window": 256}, "window",
                           ("flash_fwd", "flash_bwd_blocked"), 1),
    "long16k-ring": ("long16k", 1, 16384, 3, "tokens", {}, "contiguous",
                     ("flash_fwd", "flash_bwd_blocked"), 1),
    "long16k-zigzag": ("long16k", 1, 16384, 3, "zigzag",
                       {"sequence_layout": "zigzag"}, "zigzag",
                       ("flash_fwd", "flash_bwd_blocked"), 1),
    "long32k-ring": ("long32k", 1, 32768, 2, "tokens", {}, "contiguous",
                     ("flash_fwd", "flash_bwd_blocked"), 2),
    "long64k-ring": ("long32k", 1, 65536, 2, "tokens", {}, "contiguous",
                     ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), 2),
}
#: ``python -c CONTEXT_RANK <rank> <port> <out.json> <runs.json>``: one rank
#: of a gang of two on the one card, joined over gloo at 127.0.0.1:<port>,
#: training each run of <runs.json> on a ``data=1 × context=2`` mesh: its
#: losses, step ms, per-step launches, the ring's flash calls by shape,
#: peak memory, the ring's rotations (batches of sends and receives,
#: bytes) and the collectives per step.
CONTEXT_RANK = """
import dataclasses, datetime, gc, json, sys
import numpy as np
import torch, torch.distributed as dist
rank, port, out, spec = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=600))
from determined_tpu_torch import core
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.data import TokenDataset
from determined_tpu_torch.ops import _build
from determined_tpu_torch.parallel import MeshConfig, make_mesh
from determined_tpu_torch.parallel.ring import Ring
from determined_tpu_torch.trainer import Batch, Trainer
from determined_tpu_torch.trainer.profile import (RUNGS, RepeatedBatchTrial,
                                                  packed_batch)
with open(spec) as f:
    runs = json.load(f)
dctx = DistributedContext(rank=rank, size=2)
mesh = make_mesh(MeshConfig(data=1, context=2))
transport = Ring(mesh).transport(torch.device("cuda"))
calls, nbytes, in_step = {}, {}, [False]
def counting(name, real):
    def call(*args, **kw):
        if in_step[0]:
            t = args[1] if name in ("reduce_scatter_tensor",
                                    "all_to_all_single") else args[0]
            calls[name] = calls.get(name, 0) + 1
            nbytes[name] = nbytes.get(name, 0) + t.numel() * t.element_size()
        return real(*args, **kw)
    return call
for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "broadcast", "all_to_all_single"):
    setattr(dist, name, counting(name, getattr(dist, name)))
from determined_tpu_torch.parallel import ring as ring_mod
hop_calls, hop = {}, ring_mod.flash_attention_lse
def hop_counted(q, k, v, **kw):
    # the ring's flash calls by shape (a rematted forward counts twice)
    key = (f"{q.shape[1]}x{k.shape[1]}"
           + (" causal" if kw["causal"] else " full")
           + (" kv_offset" if kw["kv_offset"] else ""))
    hop_calls[key] = hop_calls.get(key, 0) + 1
    return hop(q, k, v, **kw)
ring_mod.flash_attention_lse = hop_counted
results = []
for run in runs:
    name, rung, b, s, steps, data, fields = (run[k] for k in (
        "name", "rung", "batch", "seq", "steps", "data", "fields"))
    cfg = dataclasses.replace(RUNGS[rung][1], **fields)
    trial = RepeatedBatchTrial(b, s, config=cfg)
    if data == "packed":
        batch = packed_batch(b, s, 3, cfg.vocab_size)
        def repeated(batch=batch):
            while True:
                yield batch
        trial.build_training_data = repeated
        trial.replicated_batch_keys = frozenset()
    elif data == "zigzag":
        def zigzag(s=s, b=b, shard=run["shard"]):
            # the rung's tokens and one more: the loader reads S + 1 a
            # row; the extra target (logical position S - 1) is masked,
            # so the loss is the in-model shift's over the rung's tokens
            for x in TokenDataset([shard], b, s, shuffle=False,
                                  zigzag_ring=2):
                mask = (x["positions"] != s - 1).astype(np.float32)
                yield dict(x, loss_mask=np.repeat(mask[None], b, 0))
        trial.build_training_data = zigzag
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(trial, core._dummy_init(distributed=dctx), mesh=mesh)
    per_step, seen = [], []
    calls.clear(); nbytes.clear(); hop_calls.clear()
    shifts0 = dict(Ring.stats)
    step_fn, flush = trainer._train_step, trainer._flush
    def counted(batch, poison=1.0):
        before = {n: k.launches for n, k in _build.KERNELS.items()}
        in_step[0] = True
        try:
            result = step_fn(batch, poison)
        finally:
            in_step[0] = False
        per_step.append({n: k.launches - before[n]
                         for n, k in _build.KERNELS.items()})
        return result
    def recording(pending, t_start):
        agg, reason = flush(pending, t_start)
        seen.append(agg)
        return agg, reason
    trainer._train_step, trainer._flush = counted, recording
    trainer.fit(max_length=Batch(steps), report_period=Batch(1))
    torch.cuda.synchronize()
    results.append(dict(
        name=name, rank=rank, transport=transport,
        losses=[m["loss"] for m in seen],
        step_ms=[1e3 / m["batches_per_second"] for m in seen],
        per_step=per_step, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        shifts_per_step=(Ring.stats["shifts"] - shifts0["shifts"]) / steps,
        rotated_mb_per_step=(Ring.stats["bytes"] - shifts0["bytes"])
        / steps / 1e6,
        hop_calls_per_step={k: v / steps for k, v in hop_calls.items()},
        collectives_per_step={k: v / steps for k, v in calls.items()},
        collective_mb_per_step={k: round(v / steps / 1e6, 3)
                                for k, v in nbytes.items()}))
    del trainer, trial
    gc.collect()
with open(out, "w") as f:
    json.dump(results, f)
dctx.close()
dist.destroy_process_group()
"""
#: phase tensor's deterministic pair: the headline trial at blocks 512
#: (``_mono_ok`` fails: ``flash_fwd`` forward) with the fused backward's
#: partials cap at 0 in every rank's process (``_bwd_route`` → the dq and
#: dk/dv passes, which sum without atomics), on one device (twice: its
#: grad norms must repeat bit for bit) and at ``tensor=2``
#: (``TWO_PASS_RUNS``), held against the one-device one on every step
TWO_PASS_FIELDS = {"flash_block_q": 512, "flash_block_k": 512}
TWO_PASS_STEPS = 3
#: phase tensor: the runs, each on ranks of the one card over gloo
#: (GPT-2-small at full width and depth, bf16 over fp32, the headline
#: trial's seeded weights carried in by ``load_jax_params``' numpy path):
#: name → (gang, mesh axes besides data=1, data ("tokens": the headline
#: trial's repeated batch, "packed": phase train-packed's batch), GPTConfig
#: fields, steps, step of a sharded save (0: none), the kernels of a
#: layer's flash calls (forward, backward), the calls a layer on a rank of
#: context index i makes ("one": 1; "ring": i + 1; "none": 0)).
TENSOR_RUNS = {
    "headline-t2": (2, {"tensor": 2}, "tokens", {}, 3, 2,
                    ("flash_fwd_mono", "flash_bwd_mono"), "one"),
    "packed-window-t2": (2, {"tensor": 2}, "packed", {"attn_window": 256},
                         3, 0, ("flash_fwd", "flash_bwd_blocked"), "one"),
    "headline-c2t2-ring": (4, {"context": 2, "tensor": 2}, "tokens", {}, 2,
                           1, ("flash_fwd_mono", "flash_bwd_mono"), "ring"),
    "headline-c2t2-ulysses": (4, {"context": 2, "tensor": 2}, "tokens",
                              {"attn_impl": "ulysses"}, 2, 0, (), "none"),
    # the deterministic pair's tensor=2 half (``TWO_PASS_RUNS``)
    "headline-t2-two-pass": (2, {"tensor": 2}, "tokens", TWO_PASS_FIELDS,
                             TWO_PASS_STEPS, 0, ("flash_fwd", "flash_bwd_dq",
                                                 "flash_bwd_dkv"), "one"),
}
TWO_PASS_RUNS = ("headline-t2-two-pass",)
#: phase tensor: each run's grad norms against the one-device run's,
#: relative; a replicated leaf's gradient summed over the tensor group
#: (t times too large) moves them past it
GRAD_NORM_RTOL = 1e-2
#: the steps whose grad norms the mono ``headline-t2`` run holds: its
#: step 3 is the one-device run's spike (15.84), where the mono
#: backward's fp32 dq atomics scatter both runs' readings from call to
#: call (2.4e-3 to 1.07e-2 relative over seven full runs on an NVIDIA
#: H100 80GB HBM3 at 700 W); the deterministic pair holds step 3 instead
TENSOR_NORM_STEPS = {"headline-t2": 2}
#: ``python -c TENSOR_RANK <rank> <world> <port> <out.json> <spec.json>``:
#: one rank of a gang on the one card, joined over gloo at
#: 127.0.0.1:<port>, training each run of the spec (phases tensor,
#: experts and pipeline; a run's own ``params`` file of whole weights, or
#: the spec's): its losses, step ms, per-step launches, peak memory,
#: resident state (``state_gb``: the working copy, the blocks that are not
#: part of it and the AdamW moments, each storage once), the collectives a
#: step by name and group, the pipeline's point-to-point MB and 1F1B stash
#: high-water mark per step, the experts' dropped-token share per layer,
#: the audits; after a run with a sharded save, the checkpoint's files, a
#: fresh trainer's bitwise restore and its losses on from the save.
TENSOR_RANK = """
import dataclasses, datetime, gc, json, os, sys
import numpy as np
import torch, torch.distributed as dist
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
out, spec = sys.argv[4], sys.argv[5]
torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=600))
from determined_tpu_torch import core
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.models import gpt
from determined_tpu_torch.ops import _build
from determined_tpu_torch.ops import flash_attention as tfa
from determined_tpu_torch.parallel import MeshConfig, make_mesh
from determined_tpu_torch.parallel import pipeline as pp
from determined_tpu_torch.parallel.ring import Ring
from determined_tpu_torch.trainer import Batch, Trainer
from determined_tpu_torch.trainer import _checkpoint as ckpt_io
from determined_tpu_torch.trainer.profile import (RUNGS, RepeatedBatchTrial,
                                                  packed_batch)
with open(spec) as f:
    spec = json.load(f)
trees = {}
def weights(path):
    if path not in trees:
        trees.clear()
        trees[path] = ckpt_io.nest(dict(np.load(path)))
    return trees[path]
dctx = DistributedContext(rank=rank, size=world)
calls, nbytes, in_step, labels = {}, {}, [False], {}
def counting(name, real):
    def call(*args, **kw):
        if in_step[0]:
            t = args[1] if name in ("reduce_scatter_tensor",
                                    "all_to_all_single") else args[0]
            key = f"{name} {labels.get(id(kw.get('group')), 'gang')}"
            calls[key] = calls.get(key, 0) + 1
            nbytes[key] = nbytes.get(key, 0) + t.numel() * t.element_size()
        return real(*args, **kw)
    return call
for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "broadcast", "all_to_all_single"):
    setattr(dist, name, counting(name, getattr(dist, name)))
class Trial(RepeatedBatchTrial):
    def build_model(self, device, mesh=None):
        model = super().build_model(device, mesh)
        if self.params is None:  # the trial's own seeded weights
            return model
        return gpt.load_jax_params(model, weights(self.params))
def shards(trainer):
    return [leaf.local.detach().cpu().clone() for _, leaf in
            ckpt_io._flatten_with_path(trainer._state_view())
            if isinstance(leaf, ckpt_io.Shard)]
results = []
cap = tfa._FUSED_BWD_PARTIALS_CAP
for run in spec["runs"]:
    name, sizes, data, fields, steps, save_at = (run[k] for k in (
        "name", "mesh", "data", "fields", "steps", "save_at"))
    fields = {k: getattr(torch, v) if k in ("dtype", "param_dtype") else v
              for k, v in fields.items()}
    # the two-pass backward (phase tensor's deterministic pair)
    tfa._FUSED_BWD_PARTIALS_CAP = 0 if run.get("two_pass") else cap
    mesh = make_mesh(MeshConfig(data=1, **sizes))
    labels.clear()
    labels.update({id(mesh.get_group(a)): a for a in (
        "fsdp", "context", "tensor", "pipeline", "expert")})
    cfg = dataclasses.replace(RUNGS["headline"][1], **fields)
    def make_trial(cfg=cfg, data=data, params=run.get("params",
                                                      spec["params"])):
        trial = Trial(8, 1024, config=cfg)
        trial.params = params
        if data == "packed":
            batch = packed_batch(8, 1024, 3, cfg.vocab_size)
            def repeated(batch=batch):
                while True:
                    yield batch
            trial.build_training_data = repeated
            trial.replicated_batch_keys = frozenset()
        return trial
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ctx = core._dummy_init(distributed=dctx,
                           checkpoint_storage=spec["ckpt"])
    trainer = Trainer(make_trial(), ctx, mesh=mesh,
                      health={"divergence_check_period": 1} if save_at
                      else None)
    labels[id(trainer._layout.replica_group)] = "replica"
    per_step, seen, audits, saved, highs, drops = [], [], [], {}, [], []
    calls.clear(); nbytes.clear()
    shifts0 = dict(Ring.stats)
    p2p0 = pp.stats["bytes"]
    step_fn, flush, audit, save = (trainer._train_step, trainer._flush,
                                   trainer._divergence_audit,
                                   trainer._save_checkpoint)
    def counted(batch, poison=1.0):
        before = {n: k.launches for n, k in _build.KERNELS.items()}
        in_step[0] = True
        pp.stats["stash_high_water"] = -1
        try:
            result = step_fn(batch, poison)
        finally:
            in_step[0] = False
        per_step.append({n: k.launches - before[n]
                         for n, k in _build.KERNELS.items()})
        highs.append(pp.stats["stash_high_water"])
        drops.append({str(i): int(d) / n for i, (d, n) in
                      sorted(trainer.model.moe_drops.items())})
        return result
    def recording(pending, t_start, flush=flush, seen=seen):
        agg, reason = flush(pending, t_start)
        seen.append(agg)
        return agg, reason
    def audited():
        audits.append(trainer.steps_completed)
        audit()
    def recording_save(**kw):
        if trainer._step == save_at:
            saved["blocks"] = shards(trainer)
        return save(**kw)
    trainer._train_step, trainer._flush = counted, recording
    trainer._divergence_audit, trainer._save_checkpoint = audited, recording_save
    trainer.fit(max_length=Batch(steps), report_period=Batch(1),
                checkpoint_period=Batch(save_at) if save_at else None)
    torch.cuda.synchronize()
    working = list(trainer.model.parameters())
    split = [t for t in trainer._params
             if all(t.data_ptr() != w.data_ptr() for w in working)]
    split += [t for s in trainer._opt_state[1][0][1:] for t in s]
    gb = lambda ts: sum(t.numel() * t.element_size() for t in ts) / 1e9
    res = dict(
        name=name, rank=rank, coordinate=[int(x) for x in
                                          mesh.get_coordinate()],
        losses=[m["loss"] for m in seen],
        grad_norms=[m["grad_norm"] for m in seen],
        step_ms=[1e3 / m["batches_per_second"] for m in seen],
        per_step=per_step, audits=audits,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
        state_gb=gb(working) + gb(split),
        wqkv_shape=list(trainer.model.blocks["wqkv"].shape),
        rotations_per_step=(Ring.stats["shifts"] - shifts0["shifts"]) / steps,
        p2p_mb_per_step=(pp.stats["bytes"] - p2p0) / steps / 1e6,
        stash_high_water=highs,
        moe_drop_share={str(i): int(d) / n for i, (d, n) in
                        sorted(trainer.model.moe_drops.items())},
        moe_drop_share_by_step=drops,
        collectives_per_step={k: v / steps for k, v in calls.items()},
        collective_mb_per_step={k: round(v / steps / 1e6, 3)
                                for k, v in nbytes.items()})
    del trainer, working, split
    gc.collect()
    torch.cuda.empty_cache()
    if save_at:
        ids = {}
        for uuid_ in os.listdir(spec["ckpt"]):
            with open(os.path.join(spec["ckpt"], uuid_, "metadata.json")) as f:
                ids[json.load(f)["steps_completed"]] = uuid_
        res["files"] = sorted(os.listdir(os.path.join(spec["ckpt"],
                                                      ids[save_at])))
        res["save_id"] = ids[save_at]
        resumed = Trainer(make_trial(), core._dummy_init(
            distributed=dctx, checkpoint_storage=spec["ckpt"]), mesh=mesh)
        seen = []
        resumed._flush = lambda p, t, flush=resumed._flush, seen=seen: (
            recording(p, t, flush, seen))
        resumed.fit(max_length=Batch(save_at), report_period=Batch(1),
                    latest_checkpoint=ids[save_at])
        got = shards(resumed)
        res["resume_bitwise"] = len(got) == len(saved["blocks"]) and all(
            torch.equal(a, b) for a, b in zip(got, saved["blocks"]))
        resumed.fit(max_length=Batch(steps), report_period=Batch(1))
        res["resumed_losses"] = [m["loss"] for m in seen]
        del resumed, got, saved
        gc.collect()
        torch.cuda.empty_cache()
    results.append(res)
with open(out, "w") as f:
    json.dump(results, f)
dctx.close()
dist.destroy_process_group()
"""
ELASTIC_STEPS = 6     # phase elastic: the resized gang's searcher operation
ELASTIC_SAVE_AT = 2   # ... its checkpoint period; rank 1 dies after it
#: ... the seconds the survivor has from the kill to its exit (it takes
#: 15-19 on the card: the resize, the restore and four steps)
ELASTIC_EXIT_S = 240
#: ``python -c ELASTIC_RANK <rank> <port> <out.json> <ckpt dir> <uuid>
#: <step>``: one rank of a gang of two on the one card over gloo at
#: ``MeshConfig(data=1, fsdp=2)`` restores the checkpoint `uuid` (saved
#: by phase tensor on another layout) onto its blocks and trains one
#: step: the restore's seconds, the state's equality across the ranks,
#: the step's loss and launches.
ELASTIC_RANK = """
import datetime, json, sys, time
import torch, torch.distributed as dist
rank, port, out, ckpt, uuid_ = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
step = int(sys.argv[6])
torch.backends.cuda.matmul.allow_tf32 = False
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=300))
from determined_tpu_torch import core
from determined_tpu_torch.core._distributed import DistributedContext
from determined_tpu_torch.ops import _build
from determined_tpu_torch.parallel import MeshConfig, make_mesh
from determined_tpu_torch.trainer import Batch, Trainer
from determined_tpu_torch.trainer.profile import RUNGS, RepeatedBatchTrial
dctx = DistributedContext(rank=rank, size=2)
mesh = make_mesh(MeshConfig(data=1, fsdp=2))
ctx = core._dummy_init(distributed=dctx, checkpoint_storage=ckpt)
trainer = Trainer(RepeatedBatchTrial(8, 1024, config=RUNGS["headline"][1]),
                  ctx, mesh=mesh)
t0 = time.perf_counter()
trainer._restore_with_fallback(uuid_)
torch.cuda.synchronize()
restore_s = time.perf_counter() - t0
assert trainer.steps_completed == step, trainer.steps_completed
seen, flush = [], trainer._flush
def recording(pending, t_start):
    agg, reason = flush(pending, t_start)
    seen.append(agg)
    return agg, reason
trainer._flush = recording
before = {n: k.launches for n, k in _build.KERNELS.items()}
trainer.fit(max_length=Batch(step + 1), report_period=Batch(1))
launches = {n: k.launches - before[n] for n, k in _build.KERNELS.items()}
loss = seen[-1]["loss"]
with open(out, "w") as f:
    json.dump(dict(rank=rank, restore_s=restore_s, loss=loss,
                   launches=launches,
                   held=[list(p.shape) for p in trainer.model.parameters()]),
              f)
dctx.close()
dist.destroy_process_group()
"""
#: phase experts: GPT-2-small's widths with a top-1 expert MLP in every
#: block, as the reference has it, in Switch-Base-8's arrangement (Fedus,
#: Zoph and Shazeer, "Switch Transformers", arXiv:2101.03961: 8 experts,
#: top-1 routing, capacity 1.25, aux weight 0.01)
EXPERT_FIELDS = {"n_experts": 8, "capacity_factor": 1.25}
EXPERT_STEPS = 4      # the one-device runs, index and dense dispatch
EXPERT_GANG_STEPS = 3  # the gangs on the one card over gloo
EXPERT_SAVE_AT = 2    # ... their sharded saves, restored onto one rank
EXPERT_TOKENS = 16    # the greedy decode's new tokens a prompt
#: the steps whose grad norms phase experts holds against the one-device
#: run at ``GRAD_NORM_RTOL``: bf16 rounding (dq by atomics, the gate's
#: gradient) flips routing decisions as the router trains, and the grad
#: norms part after the second step (index against dense dispatch on one
#: NVIDIA H100 80GB HBM3 at 700 W, 4 steps: 6e-5, 2.8e-3, 9.7e-3, 1.9e-2
#: relative); every loss is held at 1e-3
EXPERT_NORM_STEPS = 2
#: ... and the steps phase experts holds for a gang whose split changes
#: the forward's bf16 rounding (the tensor group's partial sums, the
#: ring's merged hops), which flips routing decisions already at step 1:
#: an expert that gains or loses its few tokens takes a whole Adam step
#: of difference, and the step-2 grad norms part by 1e-2 and more, the
#: same on the deterministic two-pass route (against one device on an
#: NVIDIA H100 80GB HBM3 at 700 W: ``expert=2 × tensor=2`` 6e-5 then
#: 1.13e-2 / 1.07e-2 (mono, two calls), 9.86e-3 (two-pass);
#: ``expert=2 × context=2`` ring 3.1e-4 then 1.54e-2); every loss is held
#: at 1e-3 and the first step's dropped share printed beside one
#: device's
SPLIT_NORM_STEPS = 1
#: phase experts' gangs (``TENSOR_RANK``, the trial's own seeded
#: weights): name → (ranks, mesh axes besides data=1, the step of a
#: sharded save (0: none), the flash calls a layer on context rank i
#: makes ("one": 1; "ring": i + 1), files the save must hold (the
#: experts' offsets: E 8 over expert=2: 4; f 3072 over tensor=2: 1536),
#: the steps whose grad norms are held)
EXPERT_GANGS = {
    "expert2": (2, {"expert": 2}, EXPERT_SAVE_AT, "one",
                ("params__blocks__we_in.shard0_4_0_0.npy",),
                EXPERT_NORM_STEPS),
    "expert2-t2": (4, {"expert": 2, "tensor": 2}, EXPERT_SAVE_AT, "one",
                   ("params__blocks__we_in.shard0_0_0_0.npy",
                    "params__blocks__we_in.shard0_4_0_1536.npy",
                    "params__blocks__be_in.shard0_4_1536.npy",
                    "params__blocks__we_out.shard0_4_1536_0.npy",
                    "params__blocks__router.npy"), SPLIT_NORM_STEPS),
    "expert2-c2-ring": (4, {"expert": 2, "context": 2}, 0, "ring", (),
                        SPLIT_NORM_STEPS),
}
#: phase experts' fp32 twins of the split gangs: the same gang and mesh
#: at config dtype float32 (TF32 off), GPT-2-small's widths with every
#: expert but ``n_layers`` cut to 2, held against a one-device fp32 run
#: at the same depth on every loss (``FP32_LOSS_RTOL``) and on the first
#: ``EXPERT_NORM_STEPS`` grad norms (``FP32_NORM_RTOL``): in fp32 the
#: split's rounding cannot flip routing at step 1 as bf16's does, so a
#: twin that parts is a fault of the split. name → the bf16 gang it twins
EXPERT_FP32_FIELDS = {**EXPERT_FIELDS, "n_layers": 2, "dtype": "float32"}
EXPERT_FP32_TWINS = {"expert2-t2-fp32": "expert2-t2",
                     "expert2-c2-ring-fp32": "expert2-c2-ring"}
FP32_LOSS_RTOL = 1e-5
FP32_NORM_RTOL = 1e-4
#: phase pipeline: name → (gang, mesh axes besides data=1, GPTConfig
#: fields, steps); every run is held against phase train's one-device run
PIPELINE_RUNS = {
    "gpipe-p2": (2, {"pipeline": 2}, {"pipeline_stages": 2,
                                      "pipeline_schedule": "gpipe",
                                      "num_microbatches": 4}, 3),
    "circular-p2": (2, {"pipeline": 2}, {"pipeline_stages": 2,
                                         "pipeline_schedule": "circular",
                                         "pipeline_virtual_stages": 2,
                                         "num_microbatches": 4}, 3),
    "1f1b-p2": (2, {"pipeline": 2}, {"pipeline_stages": 2,
                                     "pipeline_schedule": "1f1b",
                                     "num_microbatches": 4}, 3),
    "1f1b-p4": (4, {"pipeline": 4}, {"pipeline_stages": 4,
                                     "pipeline_schedule": "1f1b",
                                     "num_microbatches": 8}, 3),
    "1f1b-p2t2": (4, {"pipeline": 2, "tensor": 2},
                  {"pipeline_stages": 2, "pipeline_schedule": "1f1b",
                   "num_microbatches": 4}, 3),
    "1f1b-p2c2-ring": (4, {"pipeline": 2, "context": 2},
                       {"pipeline_stages": 2, "pipeline_schedule": "1f1b",
                        "num_microbatches": 4}, 3),
}
#: the steps whose grad norms phase pipeline holds against phase train's
#: at ``GRAD_NORM_RTOL``: a stage's bf16 weight gradients are rounded per
#: microbatch before their fp32 sum, and step 3 is a spike of the
#: one-device run (grad norm 15.84 after 2.97 and 1.76), which magnifies
#: the difference (``pipeline=2 × tensor=2`` on an NVIDIA H100 80GB HBM3
#: at 700 W: 1.2e-3, 1.1e-3, then 1.09e-2 relative); every loss is held
#: at 1e-3
PIPELINE_NORM_STEPS = 2
#: phase zoo: name → (the trial of
#: ``determined_tpu_torch/examples/generative_trials.py``, the reference's
#: example config it takes its hyperparameters from, the searcher metric)
ZOO_TRIALS = {"ddpm": ("DiffusionTrial", "diffusion.json", "loss"),
              "dcgan": ("DCGANTrial", "dcgan.json", "g_loss")}
ZOO_STEPS = 50        # each trial's searcher operation on one rank
ZOO_SAVE_AT = 25      # ... its checkpoint period
ZOO_SAMPLES = 16      # the DDPM's sampled images (its 200 timesteps)
#: phase autotune: the shapes ``tune_flash_blocks`` probes on the card (H
#: 12, D 64, causal, bf16): the headline batch, the same packed, and the
#: long16k rung's
AUTOTUNE_SHAPES = {"b8-s1024": dict(batch=8, s_q=1024),
                   "b8-s1024-packed": dict(batch=8, s_q=1024, segments=True),
                   "b1-s16384": dict(batch=1, s_q=16384)}
AUTOTUNE_STEPS = 2    # the autotuned GPT-2-small's steps (step 3 spikes)
#: the kernels of each backward route (``_bwd_route``)
ROUTE_KERNELS = {"mono": ("flash_bwd_mono",),
                 "fused": ("flash_bwd_blocked",),
                 "two_pass": ("flash_bwd_dq", "flash_bwd_dkv")}
#: phase integrations: the haiku slot's trials (the trial of
#: ``determined_tpu_torch/integrations/haiku.py`` or the DARTS example,
#: its hparams: the trial's defaults, the DARTS config's fixed values and
#: the reference test's two genotypes, which take all five ops)
HAIKU_TRIALS = {
    "haiku-conv": ("HaikuVisionTrial", {"arch": "conv"}),
    "haiku-mlp": ("HaikuVisionTrial", {"arch": "mlp"}),
    "darts-conv3-skip-maxpool": ("DartsBenchmarkTrial", {
        "op_0": "conv3", "op_1": "skip", "op_2": "maxpool"}),
    "darts-avgpool-conv5-skip": ("DartsBenchmarkTrial", {
        "op_0": "avgpool", "op_1": "conv5", "op_2": "skip"}),
}
DARTS_LR = 1e-3       # one draw of darts_benchmark.json's lr space
#: the HF trials at their example configs' widths (``bert_finetune.json``'s
#: lr is a search space: its upper end, 1e-4), each on the first batch of
#: its own stream repeated, so a few steps show the loss fall (GPT-2's
#: stream is uniform tokens, already near its floor ln 50257): name →
#: (trial, example, lr)
HF_TRIALS = {"hf-gpt2": ("HFTrial", "hf_gpt2.json", None),
             "hf-bert": ("HFClassifierTrial", "bert_finetune.json", 1e-4)}
INTEGRATION_STEPS = 8
#: card vs CPU fp32 logits: the largest |Δ| over the largest |logit|
LOGIT_RTOL = 1e-4
FLASH_SOURCE = "determined_tpu_torch/ops/csrc/flash_fwd.cu"
FLASH_REPLACES = "determined_tpu/ops/flash_attention.py:236"
PAGED_SOURCE = "determined_tpu_torch/ops/csrc/paged_attention.cu"
PAGED_REPLACES = "determined_tpu/ops/paged_attention.py:114"
MONO_FWD_SOURCE = "determined_tpu_torch/ops/csrc/flash_fwd_mono.cu"
MONO_FWD_REPLACES = "determined_tpu/ops/flash_attention.py:438"
MONO_BWD_SOURCE = "determined_tpu_torch/ops/csrc/flash_bwd_mono.cu"
MONO_BWD_REPLACES = "determined_tpu/ops/flash_attention.py:461"
BLOCKED_SOURCE = "determined_tpu_torch/ops/csrc/flash_bwd_blocked.cu"
BLOCKED_REPLACES = "determined_tpu/ops/flash_attention.py:499"
DQ_SOURCE = "determined_tpu_torch/ops/csrc/flash_bwd_dq.cu"
DQ_REPLACES = "determined_tpu/ops/flash_attention.py:594"
DKV_SOURCE = "determined_tpu_torch/ops/csrc/flash_bwd_dkv.cu"
DKV_REPLACES = "determined_tpu/ops/flash_attention.py:651"
PEAK_BF16 = 989e12
TRAIN_STEPS = 7
LONG_STEPS = 3        # long16k rung, full width and depth
LONG32_STEPS = 2      # long32k rung, full width and depth
PACKED_STEPS = 5      # packed documents, B=8 x 1024
PLAIN_SEQ = 4096      # second long-context reading, plain backward on all heads
#: phase train-health: the sentinel's settings, and the cost rounds
TRAIN_HEALTH = {"max_consecutive_skips": 2, "spike_zscore": 6.0,
                "spike_min_history": 4}
HEALTH_COST_ROUNDS = 3
HEALTH_COST_STEPS = 20
ENGINE_CFG = {
    "model": "small", "page_size": 128, "num_pages": 65,
    "max_pages_per_request": 8, "max_batch_size": 8, "prefill_rows": 4,
    "prefill_seq": 512, "max_new_tokens": 64,
}
#: The serving rung of the reference's bench (``bench.py:672-684``): its
#: engine geometry, its zipfian shared-prefix traffic and its draft.
SERVING_HTTP_CFG = {
    "model": "small", "page_size": 128, "num_pages": 129,
    "max_pages_per_request": 8, "max_batch_size": 8, "prefill_rows": 4,
    "prefill_seq": 512, "max_new_tokens": 128, "max_queue_depth": 64,
}
SERVING_HTTP_PROMPTS = dict(n_requests=16, corpus_size=4, prefix_len=256,
                            suffix_len=16, seed=7, vocab=200)
SERVING_HTTP_CONC = 8
SERVING_HTTP_NEW_TOKENS = 32
SERVING_HTTP_SPEC = {"mode": "ngram", "draft_len": 4, "min_match": 2}
#: The reference bench's fixture serving geometry (``bench.py:698-702``).
FIXTURE_SPEC_CFG = {
    "model": "fixture", "page_size": 16, "num_pages": 65,
    "max_pages_per_request": 4, "max_batch_size": 8, "prefill_rows": 4,
    "prefill_seq": 64, "max_new_tokens": 32, "max_queue_depth": 64,
}
NEAR_TIE = 1e-4
BLOCKED = ("flash_bwd_blocked", "flash_bwd_dq", "flash_bwd_dkv")
#: The blocked backward kernels' grid on the card (B, H 12, D 64).
BLOCKED_CASES = (
    ("causal-s2048", dict(b=1, s_q=2048, s_k=2048)),
    ("window256", dict(b=2, s_q=1024, s_k=1024, window=256, seed=1)),
    ("packed", dict(b=2, s_q=1024, s_k=1024, segs=True, seed=2)),
    ("kv-offset", dict(b=2, s_q=512, s_k=1024, kv_offset=512, seed=3)),
    ("causal-dlse", dict(b=2, s_q=1024, s_k=1024, dlse=True, seed=4)),
    ("all-masks-dlse", dict(b=2, s_q=512, s_k=1024, kv_offset=512,
                            window=256, segs=True, dlse=True, seed=5)),
)


#: The mono pair's grid on the card (name, B, H, s_q, s_k, causal, layout):
#: ragged tiles, s_q ≠ s_k under the top-left causal mask and without it,
#: misaligned views (copied before TMA), fewer work items than SMs and
#: many more (the persistent walk wraps), ``_mono_ok``'s largest square, no
#: queries, no keys.
MONO_GRID = (
    ("ragged-200", 2, 3, 200, 200, True, "qkv"),
    ("ragged-200-full", 2, 3, 200, 200, False, "qkv"),
    ("sq-lt-sk-causal", 2, 3, 96, 300, True, "qkv"),
    ("sq-gt-sk-causal", 2, 3, 300, 96, True, "qkv"),
    ("sq-lt-sk-full", 2, 3, 96, 300, False, "qkv"),
    ("sq-gt-sk-full", 2, 3, 300, 96, False, "qkv"),
    ("odd-base", 2, 3, 200, 200, True, "odd-base"),
    ("odd-stride", 2, 3, 200, 200, True, "odd-stride"),
    ("few-items", 1, 2, 128, 128, True, "qkv"),
    ("wraps", 8, 12, 1024, 1024, True, "qkv"),
    ("largest", 1, 2, 1448, 1448, True, "qkv"),
    ("no-queries", 2, 3, 0, 64, False, "qkv"),
    ("no-keys", 2, 3, 64, 0, False, "qkv"),
)


def close_rel(got, want, what, rtol=1e-3):
    """The largest relative difference of `got` from the first values of
    `want`, asserted below `rtol`."""
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    assert 0 < len(got) <= len(want) and max(rel) < rtol, (what, got, want)
    return max(rel)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cached_tail_segments(prefix_lens, tail_lens, s_q, s_p):
    """The segment ids ``_prefill_cached`` gives ``prefill_kv_cached``:
    queries 1 on each row's tail, 0 on padding; keys the row's live
    prefix (1 below its cached length, 0 past it) then the queries'
    ids."""
    import numpy as np

    qseg = np.zeros((len(tail_lens), s_q), np.int32)
    for r, n in enumerate(tail_lens):
        qseg[r, :n] = 1
    pseg = (np.arange(s_p)[None, :]
            < np.asarray(prefix_lens)[:, None]).astype(np.int32)
    return qseg, np.concatenate([pseg, qseg], axis=1)


def spec_gather_segments(b, q, s_max, seed):
    """The segment ids ``decode_kv_spec``'s gather path gives flash
    attention for `b` slots of `q` rows over an `s_max` window: ragged
    lengths (one reaching the window's last page), q_lens in [1, q], slot
    4 inactive. → (q [b, q], kv [b, s_max + q])."""
    import numpy as np

    rng = np.random.default_rng(seed)
    q_lens = rng.integers(1, q + 1, size=b)
    lengths = np.minimum(np.array([0, 1023, 517, 1, 260, 900, 128, 64][:b]),
                         s_max - q_lens)
    active = np.arange(b) != 4
    win = (np.arange(s_max)[None, :] < lengths[:, None]) & active[:, None]
    tail = (np.arange(q)[None, :] < q_lens[:, None]) & active[:, None]
    return (np.where(tail, 1, 2).astype(np.int32),
            np.concatenate([win, tail], axis=1).astype(np.int32))


def packed_batch(b, s, seed, vocab):
    """One ``pack_sequences`` batch [b, s] of seeded random documents of
    32-1024 tokens below `vocab` (tokens, segment_ids, loss_mask)."""
    from determined_tpu_torch.trainer.profile import packed_batch as batch

    return batch(b, s, seed, vocab)


class StandInMaster:
    """A stand-in for the reference master (``determined_tpu/master/
    api_server.py``) that answers only the routes the port's trial and
    serving replica call, with the master's answer shapes, on
    ``ThreadingHTTPServer`` at 127.0.0.1. The card's machine cannot run
    the reference master (it imports ``requests``).

    Every request is recorded as ``(method, path, headers, body)``. The
    master's part is scripted: ``op_length`` is the searcher operation
    every trial gets until it posts ``searcher/completed``;
    ``capture_at_step`` hands one ``profile_capture`` directive to the
    first chief heartbeat at or past that step; ``preempt_after_step``
    sets the beating allocation's preemption signal once a heartbeat
    reports that step; ``preempt(alloc)`` sets it by hand. The preemption
    long-poll holds until the signal is set or its ``timeout_seconds``
    pass; so does the rendezvous table, until ``rendezvous_size``
    processes of the allocation have posted their address.
    ``resize(alloc, lost_ranks)`` is the master's elastic resize: the
    survivors re-numbered in rank order under the next generation; a
    caller at an older generation then gets the directive on its beat and
    on its preemption poll (which returns at once), and a 409 with it from
    the rendezvous routes. ``tests/test_torch_cluster.py`` holds every
    answer's keys and value types against the live master's."""

    ROUTES = (
        ("POST", r"/api/v1/trials/(\d+)/metrics", "_metrics"),
        ("POST", r"/api/v1/trials/(\d+)/progress", "_empty"),
        ("POST", r"/api/v1/trials/(\d+)/status", "_empty"),
        ("GET", r"/api/v1/trials/(\d+)/searcher/operation", "_operation"),
        ("POST", r"/api/v1/trials/(\d+)/searcher/progress", "_empty"),
        ("POST", r"/api/v1/trials/(\d+)/searcher/completed", "_completed"),
        ("GET", r"/api/v1/trials/(\d+)/checkpoints", "_trial_checkpoints"),
        ("POST", r"/api/v1/checkpoints", "_checkpoint"),
        ("POST", r"/api/v1/allocations/([\w.\-]+)/progress", "_beat"),
        ("GET", r"/api/v1/allocations/([\w.\-]+)/signals/preemption",
         "_preemption"),
        ("POST", r"/api/v1/allocations/([\w.\-]+)/signals/ack_preemption",
         "_ack"),
        ("POST", r"/api/v1/allocations/([\w.\-]+)/proxy", "_proxy"),
        ("POST", r"/api/v1/allocations/([\w.\-]+)/rendezvous", "_arrive"),
        ("GET", r"/api/v1/allocations/([\w.\-]+)/rendezvous", "_table"),
        ("POST", r"/api/v1/traces/ingest", "_spans"),
        ("POST", r"/api/v1/profiles/ingest", "_windows"),
        ("POST", r"/api/v1/logs/ingest", "_lines"),
        ("POST", r"/api/v1/profiles/captures/([\w\-]+)/complete",
         "_capture_complete"),
    )

    def __init__(self, op_length: int = 1) -> None:
        import re
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.op_length = op_length
        self.capture_at_step = None
        self.capture_steps = 2
        self.preempt_after_step = None
        self.requests = []
        self.checkpoints = {}       # uuid -> the registration body
        self.spans, self.windows, self.lines = [], [], []
        self.captures = {}          # id -> the capture record
        self.proxies = {}           # allocation -> (host, port)
        self.completed = {}         # trial id -> searcher/completed body
        self.acked = set()
        self.rendezvous_size = 1
        self.addrs = {}             # allocation -> {rank: address}
        self.resizes = {}           # allocation -> its latest directive
        self._preempt = set()
        self._cond = threading.Condition()
        self._routes = [(m, re.compile(f"^{p}$"), getattr(self, h))
                        for m, p, h in self.ROUTES]
        stand_in = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, *args):
                pass

            def _dispatch(self, method):
                from urllib.parse import parse_qs, urlparse

                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b""
                body = json.loads(raw) if raw else {}
                url = urlparse(self.path)
                with stand_in._cond:
                    stand_in.requests.append(
                        (method, url.path, dict(self.headers.items()), body))
                status, payload = 404, {"error": f"no route {url.path}"}
                for m, pat, handler in stand_in._routes:
                    match = pat.match(url.path)
                    if m == method and match:
                        status, payload = 200, handler(
                            match.groups(), body, parse_qs(url.query),
                            self.client_address[0])
                        if isinstance(payload, tuple):
                            status, payload = payload
                        break
                data = json.dumps(payload).encode()
                try:
                    self.send_response(status)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # a task that exited mid long-poll

            def do_GET(self):  # noqa: N802
                self._dispatch("GET")

            def do_POST(self):  # noqa: N802
                self._dispatch("POST")

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self._httpd.server_address[1]}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="stand-in-master", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._cond:
            self._preempt.add("*")   # release held long-polls
            self._cond.notify_all()
        self._httpd.shutdown()
        self._httpd.server_close()

    def preempt(self, alloc: str) -> None:
        with self._cond:
            self._preempt.add(alloc)
            self._cond.notify_all()

    def _preempted(self, alloc: str) -> bool:
        return alloc in self._preempt or "*" in self._preempt

    def resize(self, alloc: str, lost_ranks, reason: str = "") -> dict:
        """The master's elastic resize of `alloc`'s gang: the ranks but
        `lost_ranks` re-numbered 0.. in rank order, the generation
        bumped, the rendezvous table reset."""
        with self._cond:
            last = self.resizes.get(alloc)
            gen = last["generation"] if last else 0
            size = last["num_processes"] if last else self.rendezvous_size
            survivors = [r for r in range(size) if r not in set(lost_ranks)]
            directive = {
                "generation": gen + 1, "from_generation": gen,
                "num_processes": len(survivors),
                "rank_map": {str(old): new
                             for new, old in enumerate(survivors)},
                "reason": reason,
            }
            self.resizes[alloc] = directive
            self.addrs[alloc] = {}
            self._cond.notify_all()
            return dict(directive)

    def _stale(self, alloc: str, generation) -> dict:
        """The directive a caller at `generation` must apply, or None."""
        directive = self.resizes.get(alloc)
        if (directive is None or generation is None
                or int(generation) >= directive["generation"]):
            return None
        return dict(directive)

    def _fence(self, alloc: str, generation):
        """The live master's 409 for a stale rendezvous generation."""
        directive = self._stale(alloc, generation)
        if directive is None:
            return None
        return 409, {"error": f"allocation {alloc}: generation "
                              f"{generation} is stale (now "
                              f"{directive['generation']})",
                     "resync": True, "generation": directive["generation"],
                     "resize": directive}

    # -- the routes: answers shaped as api_server.py's -----------------------
    def _empty(self, groups, body, query, client):
        return {}

    def _metrics(self, groups, body, query, client):
        return {}

    def _operation(self, groups, body, query, client):
        with self._cond:
            if int(groups[0]) in self.completed:
                return {"completed": True, "op": None}
        return {"op": {"length": self.op_length}, "completed": False}

    def _completed(self, groups, body, query, client):
        with self._cond:
            self.completed[int(groups[0])] = body
        return {}

    def _checkpoint(self, groups, body, query, client):
        import time as time_mod

        with self._cond:
            self.checkpoints[body["uuid"]] = dict(
                body, report_time=time_mod.time())
        return {}

    def _trial_checkpoints(self, groups, body, query, client):
        with self._cond:
            rows = [
                {"uuid": u, "trial_id": b.get("trial_id"),
                 "task_id": b.get("task_id", ""),
                 "allocation_id": b.get("allocation_id", ""),
                 "report_time": b["report_time"], "state": b["state"],
                 "resources": b.get("resources", []),
                 "metadata": b.get("metadata", {}),
                 "steps_completed": int((b.get("metadata") or {}).get(
                     "steps_completed") or 0)}
                for u, b in self.checkpoints.items()
                if b.get("trial_id") == int(groups[0])
                and b["state"] == "COMPLETED"]
        return {"checkpoints": sorted(
            rows, key=lambda r: r["steps_completed"])}

    def _beat(self, groups, body, query, client):
        import secrets

        alloc, step = groups[0], int(body.get("step", 0))
        resp = {}
        with self._cond:
            directive = self._stale(alloc, body.get("generation"))
            if directive is not None:
                return {"resize": directive}
            if (self.preempt_after_step is not None
                    and step >= self.preempt_after_step):
                self._preempt.add(alloc)
                self._cond.notify_all()
            if (int(body.get("rank", 0)) == 0
                    and self.capture_at_step is not None
                    and step >= self.capture_at_step):
                self.capture_at_step = None
                cid = "cap-" + secrets.token_hex(6)
                self.captures[cid] = {"id": cid, "steps": self.capture_steps}
                resp["profile_capture"] = {"id": cid,
                                           "steps": self.capture_steps}
        return resp

    def _preemption(self, groups, body, query, client):
        import time as time_mod

        alloc = groups[0]
        wait = float((query.get("timeout_seconds") or ["60"])[0])
        gen = (query.get("generation") or [None])[0]
        deadline = time_mod.time() + wait
        with self._cond:
            while (not self._preempted(alloc)
                   and self._stale(alloc, gen) is None):
                left = deadline - time_mod.time()
                if left <= 0:
                    break
                self._cond.wait(timeout=min(left, 1.0))
            resp = {"preempt": self._preempted(alloc)}
            directive = self._stale(alloc, gen)
            if directive is not None:
                resp["resize"] = directive
            return resp

    def _ack(self, groups, body, query, client):
        with self._cond:
            self.acked.add(groups[0])
        return {}

    def _proxy(self, groups, body, query, client):
        with self._cond:
            self.proxies[groups[0]] = (body.get("host") or client,
                                       int(body["port"]))
            self._cond.notify_all()
        return {"url": f"/proxy/{groups[0]}/"}

    def _arrive(self, groups, body, query, client):
        with self._cond:
            fenced = self._fence(groups[0], body.get("generation", 0))
            if fenced is not None:
                return fenced
            self.addrs.setdefault(groups[0], {})[int(body["rank"])] = \
                body["addr"]
            self._cond.notify_all()
        return {}

    def _table(self, groups, body, query, client):
        import time as time_mod

        wait = float((query.get("timeout_seconds") or ["600"])[0])
        deadline = time_mod.time() + wait
        with self._cond:
            fenced = self._fence(groups[0],
                                 (query.get("generation") or ["0"])[0])
            if fenced is not None:
                return fenced
            last = self.resizes.get(groups[0])
            size = last["num_processes"] if last else self.rendezvous_size
            table = self.addrs.setdefault(groups[0], {})
            while len(table) < size:
                left = deadline - time_mod.time()
                if left <= 0:
                    break
                self._cond.wait(timeout=min(left, 1.0))
            addrs = [table[r] for r in sorted(table)]
            return {"container_addrs": addrs,
                    "coordinator_address": addrs[0] if addrs else "",
                    "num_processes": size}

    def _spans(self, groups, body, query, client):
        with self._cond:
            self.spans.extend(body.get("spans") or [])
        return {"stored": len(body.get("spans") or [])}

    def _windows(self, groups, body, query, client):
        with self._cond:
            self.windows.extend(body.get("windows") or [])
        return {"stored": {"accepted": len(body.get("windows") or []),
                           "rejected": 0}}

    def _lines(self, groups, body, query, client):
        with self._cond:
            self.lines.extend(body.get("lines") or [])
        return {"stored": len(body.get("lines") or [])}

    def _capture_complete(self, groups, body, query, client):
        import time as time_mod

        with self._cond:
            cap = self.captures.setdefault(
                groups[0], {"id": groups[0], "steps": self.capture_steps})
            cap.update(artifact=body.get("artifact", ""),
                       error=body.get("error", ""))
            now = time_mod.time()
            return {
                "id": groups[0], "kind": "trial", "ident": "1",
                "steps": cap["steps"],
                "state": "failed" if cap["error"] else "completed",
                "created_at": now, "delivered_at": now, "completed_at": now,
                "artifact": cap["artifact"] or None,
                "error": cap["error"] or None,
            }

    def wait_for(self, predicate, timeout: float, what: str):
        """Block until `predicate()` (called under the lock) is true."""
        import time as time_mod

        deadline = time_mod.time() + timeout
        with self._cond:
            while not predicate():
                left = deadline - time_mod.time()
                assert left > 0, f"stand-in master: timed out waiting for {what}"
                self._cond.wait(timeout=min(left, 0.5))


class Smoke:
    def __init__(self, torch, card: str) -> None:
        self.torch = torch
        self.card = card
        self.dev = torch.device("cuda", 0)
        self.peak = {torch.bfloat16: 989e12, torch.float32: 67e12}

    # -- helpers ------------------------------------------------------------
    def time_ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        """Device ms per call: CUDA events around `iters` calls queued
        behind a ~50 ms spin kernel, so the host has enqueued them all
        before the first starts and its per-call overhead (and any CPU
        contention) adds no gaps between them."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def bound(self, flops: float, nbytes: float, dtype):
        t_ops = flops / self.peak[dtype]
        t_bytes = nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    def randn(self, shape, dtype, gen):
        return self.torch.randn(shape, generator=gen, device=self.dev).to(dtype)

    # -- phase 3: flash forward ------------------------------------------------
    def flash_case(self, name, dtype, *, b, s_q, s_k, kv_offset=0,
                   window=None, segs=None, seed=0, block=512, h=12):
        """flash_fwd against its plain version and SDPA. `segs`: None,
        "packed" (seeded documents), "decode" (the gather-decode layout),
        "spec" (the speculative gather verify's), an int32 [b, s_k] array
        of segment ids, or a (q [b, s_q], kv [b, s_k]) pair of them."""
        import numpy as np
        import torch
        import torch.nn.functional as F

        from determined_tpu_torch.ops import flash_attention as tfa

        d = 64
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        rng = np.random.default_rng(seed)
        q = self.randn((b, s_q, h, d), dtype, gen)
        k = self.randn((b, s_k, h, d), dtype, gen)
        v = self.randn((b, s_k, h, d), dtype, gen)
        qseg = kseg = None
        if isinstance(segs, tuple):
            qseg, kseg = (torch.from_numpy(np.asarray(x, np.int32)).to(
                self.dev) for x in segs)
        elif segs is not None and not isinstance(segs, str):
            qseg = kseg = torch.from_numpy(np.asarray(segs, np.int32)).to(
                self.dev)
        elif segs == "packed":
            ids = np.zeros((b, s_k), np.int32)
            for r in range(b):
                n_docs = int(rng.integers(3, 6))
                used = int(rng.integers(s_k * 3 // 4, s_k - 8))
                cuts = np.sort(rng.choice(np.arange(1, used), n_docs - 1,
                                          replace=False))
                for i, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, used])):
                    ids[r, lo:hi] = i + 1
            qseg = kseg = torch.from_numpy(ids).to(self.dev)
        elif segs == "decode":
            lengths = np.array([0, 1023, 517, 1, 260, 900, 128, 64][:b])
            active = np.arange(b) != 4
            pos = np.arange(s_k)[None, :]
            kseg = torch.from_numpy(
                ((pos <= lengths[:, None]) & active[:, None]).astype(np.int32)
            ).to(self.dev)
            qseg = torch.from_numpy(
                np.where(active, 1, 2).astype(np.int32)[:, None]
            ).to(self.dev)
        elif segs == "spec":
            # decode_kv_spec's gather layout: the committed window (pos <
            # length) and the s_q fresh rows behind it; dead rows carry
            # query segment 2, which no key carries
            qseg, kseg = (torch.from_numpy(x).to(self.dev)
                          for x in spec_gather_segments(b, s_q, s_k - s_q,
                                                        seed))
        kw = dict(causal=True, window=window, kv_offset=kv_offset,
                  segment_ids=qseg, kv_segment_ids=kseg,
                  block_q=tfa.fit_block(s_q, block),
                  block_k=tfa.fit_block(s_k, block))
        fw = dict(causal=True, window=window, kv_offset=kv_offset,
                  segment_ids=qseg, kv_segment_ids=kseg)
        o_k, lse_k = tfa.flash_attention_lse(q, k, v, **kw)
        o_p, lse_p = tfa.flash_attention_lse_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        self.check(name, dtype, o_k, o_p, lse_k, lse_p)
        # the kernel against its own plain version (p rounded where the
        # kernel rounds it)
        o_k, lse_k = tfa.flash_fwd(q, k, v, **fw)
        o_p, lse_p = tfa.flash_fwd_plain(q, k, v, **fw)
        torch.cuda.synchronize()
        self.check(f"{name} kernel-level", dtype, o_k, o_p, lse_k, lse_p)
        err = float((o_k.float() - o_p.float()).abs().max())

        # dense mask of the same function: band + segments → live pairs
        rows = torch.arange(s_q, device=self.dev)[:, None] + kv_offset
        cols = torch.arange(s_k, device=self.dev)[None, :]
        mask = (rows >= cols)
        if window is not None:
            mask = mask & (rows - cols < window)
        mask = mask[None].expand(b, s_q, s_k)
        if qseg is not None:
            mask = mask & (qseg[:, :, None] == kseg[:, None, :])
        live = int(mask.sum()) * h
        item = q.element_size()
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * item \
            + 4 * b * s_q * h + (4 * b * (s_q + s_k) if qseg is not None else 0)
        bound_ms, bound_by = self.bound(4.0 * d * live, nbytes, dtype)
        ms = self.time_ms(lambda: tfa.flash_fwd(q, k, v, **fw))
        plain_ms = self.time_ms(
            lambda: tfa.flash_fwd_plain(q, k, v, **fw), iters=5)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        attn_mask = mask[:, None]
        library_ms = self.time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=attn_mask))
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                   **self.rates(4.0 * d * live, ms, bound_ms))
        self.report("kernels", f"flash_fwd {name} {str(dtype)[6:]}", rec)
        return rec

    def rates(self, flops, ms, bound_ms):
        """A record's TFLOP/s on live pairs and share of the bound."""
        return dict(tflops=flops / ms / 1e9, bound_share=bound_ms / ms)

    # -- phase 3: paged decode ------------------------------------------------
    def paged_case(self, name, dtype, *, q_rows, ragged, seed=0, full=False,
                   max_q_len=5):
        """paged_attention against its plain version and gather + SDPA, 8
        pages of 128 tokens a slot, H 12, D 64: the engine's decode batch
        (8 slots of ragged lengths, one inactive; `ragged`: q_lens drawn
        from [1, max_q_len]), or with `full` 32 slots of 8 full pages
        (100.7 MB of bf16 K/V, where bytes and not latency set the time).
        Two launches must agree bit for bit."""
        import numpy as np
        import torch
        import torch.nn.functional as F

        from determined_tpu_torch.ops import paged_attention as tpa

        b, p, ps, h, d = (32 if full else 8), 8, 128, 12, 64
        num_pages = b * p + 1
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        rng = np.random.default_rng(seed)
        k_pool = self.randn((num_pages, ps, h, d), dtype, gen)
        v_pool = self.randn((num_pages, ps, h, d), dtype, gen)
        pt = rng.permutation(np.arange(1, num_pages)).reshape(b, p)
        q_lens = (rng.integers(1, max_q_len + 1, size=b) if ragged
                  else np.ones(b, np.int64))
        if full:
            lengths = np.full(b, p * ps - 1)
            active = np.ones(b, bool)
        else:
            lengths = np.array([0, 1023, 517, 1, 260, 900, 128, 64])
            active = np.arange(b) != 4
        lengths = np.minimum(lengths, p * ps - q_lens)
        q = self.randn((b, q_rows, h, d), dtype, gen)
        dev_i32 = [torch.from_numpy(a.astype(np.int32)).to(self.dev)
                   for a in (pt, lengths, active, q_lens)]
        args = (q, k_pool, v_pool, *dev_i32[:3])
        kw = dict(q_lens=dev_i32[3])
        o_k = tpa.paged_attention(*args, **kw)
        o_p = tpa.paged_attention_plain(*args, **kw)
        again = tpa.paged_attention(*args, **kw)
        torch.cuda.synchronize()
        self.check(name, dtype, o_k, o_p)
        assert torch.equal(o_k, again), f"paged {name}: launches differ"
        err = float((o_k.float() - o_p.float()).abs().max())

        r = np.arange(q_rows)[None, :]
        visible = lengths[:, None] + np.minimum(r, q_lens[:, None] - 1) + 1
        flops = 4.0 * d * h * float((visible * active[:, None]).sum())
        item = q.element_size()
        kv_bytes = 2 * item * h * d * float(((lengths + q_lens) * active).sum())
        nbytes = kv_bytes + 2 * q.numel() * item + 4 * (b * p + 3 * b)
        bound_ms, bound_by = self.bound(flops, nbytes, dtype)
        ms = self.time_ms(lambda: tpa.paged_attention(*args, **kw))
        plain_ms = self.time_ms(
            lambda: tpa.paged_attention_plain(*args, **kw), iters=5)
        pt_long = dev_i32[0].long()
        cols = torch.arange(p * ps, device=self.dev)
        bound = torch.from_numpy(visible - 1).to(self.dev)
        attn_mask = ((cols[None, None, :] <= bound[:, :, None])
                     & torch.from_numpy(active).to(self.dev)[:, None, None])
        attn_mask = attn_mask[:, None]
        qh = q.transpose(1, 2)

        def library():
            k_full = k_pool[pt_long].reshape(b, p * ps, h, d).transpose(1, 2)
            v_full = v_pool[pt_long].reshape(b, p * ps, h, d).transpose(1, 2)
            return F.scaled_dot_product_attention(qh, k_full, v_full,
                                                  attn_mask=attn_mask)

        library_ms = self.time_ms(library)
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                   **self.rates(flops, ms, bound_ms))
        self.report("kernels", f"paged_attention {name} {str(dtype)[6:]}", rec)
        return rec

    # -- phase 3: the mono pair (training attention) ----------------------------
    def mono_case(self, name, dtype, *, b, s, causal, dlse, seed=0,
                  timed=False, h=12):
        import torch
        import torch.nn.functional as F

        from determined_tpu_torch.ops import flash_attention as tfa

        d = 64
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        qkv = self.randn((b, s, 3, h, d), dtype, gen)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # as GPT passes them
        do = self.randn((b, s, h, d), dtype, gen)
        dl = (torch.randn((b, s, h), generator=gen, device=self.dev)
              if dlse else None)
        o_k, lse_k = tfa.flash_fwd_mono(q, k, v, causal=causal)
        o_p, lse_p = tfa.flash_fwd_mono_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        self.check(f"{name} fwd", dtype, o_k, o_p, lse_k, lse_p)
        delta = (do.float() * o_p.float()).sum(-1)
        bwd_args = (q, k, v, do, lse_p, delta, dl)
        g_k = tfa.flash_bwd_mono(*bwd_args, causal=causal)
        g_p = tfa.flash_bwd_mono_plain(*bwd_args, causal=causal)
        torch.cuda.synchronize()
        for which, gk, gp in zip(("dq", "dk", "dv"), g_k, g_p):
            if dtype == torch.bfloat16:
                torch.testing.assert_close(gk.float(), gp.float(), atol=2e-2,
                                           rtol=2e-2, msg=f"{name}: {which}")
            else:
                torch.testing.assert_close(gk, gp, atol=1e-5, rtol=1e-5,
                                           msg=f"{name}: {which}")
        fwd_err = float((o_k.float() - o_p.float()).abs().max())
        bwd_err = max(float((gk.float() - gp.float()).abs().max())
                      for gk, gp in zip(g_k, g_p))
        tag = f"{name} {str(dtype)[6:]}"
        if not timed:
            self.report("kernels", f"flash_fwd_mono {tag}",
                        dict(max_abs_err=fwd_err))
            self.report("kernels", f"flash_bwd_mono {tag}",
                        dict(max_abs_err=bwd_err))
            return None, None
        live = b * h * (s * (s + 1) // 2 if causal else s * s)
        item = q.element_size()
        qkv_bytes = 3 * q.numel() * item
        rows = 4 * b * s * h  # one fp32 per (b, query, head)
        fwd_bound = self.bound(4.0 * d * live, qkv_bytes + o_k.numel() * item
                               + rows, dtype)
        bwd_bound = self.bound(
            10.0 * d * live,
            qkv_bytes + do.numel() * item + (3 if dlse else 2) * rows
            + 3 * q.numel() * item, dtype)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        recs = []
        for kname, per_pair, kernel, plain, library, (bound_ms, bound_by), \
                err in (
            ("flash_fwd_mono", 4,
             lambda: tfa.flash_fwd_mono(q, k, v, causal=causal),
             lambda: tfa.flash_fwd_mono_plain(q, k, v, causal=causal),
             lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                    is_causal=causal),
             fwd_bound, fwd_err),
            ("flash_bwd_mono", 10,
             lambda: tfa.flash_bwd_mono(*bwd_args, causal=causal),
             lambda: tfa.flash_bwd_mono_plain(*bwd_args, causal=causal),
             self.sdpa_backward(qh, kh, vh, do, causal),
             bwd_bound, bwd_err),
        ):
            ms = self.time_ms(kernel)
            recs.append(dict(
                ms=ms, plain_ms=self.time_ms(plain, iters=5),
                library_ms=self.time_ms(library), bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err,
                **self.rates(per_pair * d * live, ms, bound_ms),
            ))
        # the blocked sm90 kernels on the same inputs: that design's time
        # at this size with nothing mono-specific
        recs[0]["blocked_sm90_ms"] = self.time_ms(
            lambda: tfa.flash_fwd(q, k, v, causal=causal))
        recs[1]["blocked_sm90_ms"] = self.time_ms(
            lambda: tfa.flash_bwd_blocked(*bwd_args, causal=causal))
        # what the backward's wrapper adds around its kernel: zeroing the
        # fp32 dq workspace and casting it to the input dtype
        ws = torch.zeros((b, s, h, d), dtype=torch.float32, device=self.dev)
        recs[1]["dq_zero_ms"] = self.time_ms(
            lambda: torch.zeros((b, s, h, d), dtype=torch.float32,
                                device=self.dev))
        recs[1]["dq_cast_ms"] = self.time_ms(lambda: ws.to(dtype))
        self.report("kernels", f"flash_fwd_mono {tag}", recs[0])
        self.report("kernels", f"flash_bwd_mono {tag}", recs[1])
        return recs

    def mono_grid(self, dtype):
        """The mono pair against its plain versions over ``MONO_GRID`` at
        every head dim, with and without an lse cotangent; one line with
        the cases run and the largest differences."""
        import torch

        from determined_tpu_torch.ops import flash_attention as tfa

        errs = {"fwd": 0.0, "bwd": 0.0}
        n = 0
        for name, b, h, s_q, s_k, causal, layout in MONO_GRID:
            for d in (16, 32, 64, 128):
                gen = torch.Generator(device=self.dev).manual_seed(d + s_q)
                q, k, v, do = self.layout_views(dtype, layout, b, h, s_q,
                                                s_k, d, gen)
                dl = torch.randn((b, s_q, h), generator=gen, device=self.dev)
                tag = f"mono grid {name} d{d} {str(dtype)[6:]}"
                o_k, lse_k = tfa.flash_fwd_mono(q, k, v, causal=causal)
                o_p, lse_p = tfa.flash_fwd_mono_plain(q, k, v, causal=causal)
                torch.cuda.synchronize()
                self.check(tag, dtype, o_k, o_p, lse_k, lse_p)
                if o_k.numel():
                    errs["fwd"] = max(errs["fwd"], float(
                        (o_k.float() - o_p.float()).abs().max()))
                delta = (do.float() * o_p.float()).sum(-1)
                for cot in (None, dl):
                    args = (q, k, v, do, lse_p, delta, cot)
                    got = tfa.flash_bwd_mono(*args, causal=causal)
                    want = tfa.flash_bwd_mono_plain(*args, causal=causal)
                    torch.cuda.synchronize()
                    errs["bwd"] = max(errs["bwd"],
                                      self.hold_grads(tag, dtype, got, want))
                n += 1
        self.report("kernels", f"mono grid {str(dtype)[6:]}",
                    dict(cases=n, fwd_max_abs_err=errs["fwd"],
                         bwd_max_abs_err=errs["bwd"]))

    def layout_views(self, dtype, layout, b, h, s_q, s_k, d, gen):
        """q/k/v as the kernels meet them: "qkv" strided views of one
        [B, S, 3, H, D] projection (as GPT passes them), "odd-base"
        contiguous tensors one element past 16-byte alignment, "odd-stride"
        rows padded to D + 1 elements; and do."""
        if layout == "qkv":
            qkv = self.randn((b, max(s_q, s_k), 3, h, d), dtype, gen)
            q, k, v = qkv[:, :s_q, 0], qkv[:, :s_k, 1], qkv[:, :s_k, 2]
        elif layout == "odd-base":
            n_q, n_k = b * s_q * h * d, b * s_k * h * d
            flat = self.randn((n_q + 2 * n_k + 1,), dtype, gen)
            q = flat[1:1 + n_q].view(b, s_q, h, d)
            k = flat[1 + n_q:1 + n_q + n_k].view(b, s_k, h, d)
            v = flat[1 + n_q + n_k:].view(b, s_k, h, d)
        else:
            q = self.randn((b, s_q, h, d + 1), dtype, gen)[..., :d]
            k = self.randn((b, s_k, h, d + 1), dtype, gen)[..., :d]
            v = self.randn((b, s_k, h, d + 1), dtype, gen)[..., :d]
        return q, k, v, self.randn((b, s_q, h, d), dtype, gen)

    def sdpa_backward(self, qh, kh, vh, do, causal, attn_mask=None):
        """SDPA's backward alone: autograd.grad over a retained graph."""
        import torch
        import torch.nn.functional as F

        xs = [x.detach().requires_grad_() for x in (qh, kh, vh)]
        out = F.scaled_dot_product_attention(*xs, is_causal=causal,
                                             attn_mask=attn_mask)
        doh = do.transpose(1, 2).contiguous()
        return lambda: torch.autograd.grad(out, xs, doh, retain_graph=True)

    # -- phase 3: the blocked backward kernels ----------------------------------
    def blocked_inputs(self, dtype, *, b, s_q, s_k, kv_offset=0, window=None,
                       segs=False, dlse=False, seed=0, h=12):
        """q/k/v as strided views of one [B, S, 3, H, D] tensor (as GPT
        passes them), do, lse/delta from the plain forward, an optional lse
        cotangent and segment ids (`segs`: True for seeded documents of
        32-512 tokens, or an int32 [b, s_k] array) → (positional args,
        keyword args) of the kernel-level backward wrappers."""
        import numpy as np
        import torch

        from determined_tpu_torch.ops import flash_attention as tfa

        d = 64
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        qkv = self.randn((b, s_k, 3, h, d), dtype, gen)
        q = qkv[:, s_k - s_q:, 0]
        k, v = qkv[:, :, 1], qkv[:, :, 2]
        do = self.randn((b, s_q, h, d), dtype, gen)
        dl = (torch.randn((b, s_q, h), generator=gen, device=self.dev)
              if dlse else None)
        kw = dict(causal=True, window=window, kv_offset=kv_offset)
        if segs is True:
            rng = np.random.default_rng(seed)
            ids = np.zeros((b, s_k), np.int32)
            for r in range(b):
                pos, doc = 0, 1
                while pos < s_k:
                    n = int(rng.integers(32, 513))
                    ids[r, pos:pos + n] = doc
                    pos, doc = pos + n, doc + 1
            segs = ids
        if segs is not False:
            kseg = torch.from_numpy(np.asarray(segs, np.int32)).to(self.dev)
            kw.update(segment_ids=kseg[:, s_k - s_q:], kv_segment_ids=kseg)
        o, lse = tfa.flash_attention_lse_plain(
            q, k, v, block_q=s_q, block_k=tfa.fit_block(s_k, 1024), **kw)
        delta = (do.float() * o.float()).sum(-1)
        return (q, k, v, do, lse, delta, dl), kw

    def blocked_run(self, name, args, kw):
        """One blocked backward kernel on the card → (dq, dk, dv), None
        where it computes nothing."""
        from determined_tpu_torch.ops import flash_attention as tfa

        if name == "flash_bwd_dq":
            return tfa.flash_bwd_dq(*args, **kw), None, None
        if name == "flash_bwd_dkv":
            return (None, *tfa.flash_bwd_dkv(*args, **kw))
        return tfa.flash_bwd_blocked(*args, **kw)

    def hold_grads(self, what, dtype, got, want):
        """Each gradient the kernel computed against the plain one (bf16
        atol/rtol 2e-2, fp32 1e-5) → the largest difference."""
        torch = self.torch
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        err = 0.0
        for which, g, w in zip(("dq", "dk", "dv"), got, want):
            if g is None:
                continue
            torch.testing.assert_close(g.float(), w.float(), atol=tol,
                                       rtol=tol, msg=f"{what}: {which}")
            if g.numel():
                err = max(err, float((g.float() - w.float()).abs().max()))
        return err

    def fwd_plain_by_head(self, q, k, v):
        """flash_fwd_plain (causal) one head at a time → (o, lse)."""
        import torch

        from determined_tpu_torch.ops import flash_attention as tfa

        parts = [tfa.flash_fwd_plain(q[:, :, i:i + 1], k[:, :, i:i + 1],
                                     v[:, :, i:i + 1], causal=True)
                 for i in range(q.shape[2])]
        return tuple(torch.cat(x, dim=2) for x in zip(*parts))

    def plain_by_head(self, args, kw):
        """The dense plain backward one head at a time, so one [S, S] fp32
        score matrix is live per call (1.1 GB at S 16384, 4.3 GB at 32768)
        → (dq, dk, dv) of every head."""
        import torch

        from determined_tpu_torch.ops import flash_attention as tfa

        parts = [
            tfa.flash_bwd_blocked_plain(
                *(None if x is None else x[:, :, i:i + 1] for x in args), **kw)
            for i in range(args[0].shape[2])
        ]
        return tuple(torch.cat(g, dim=2) for g in zip(*parts))

    def blocked_case(self, name, dtype, timed=False, **shape):
        """flash_bwd_blocked, and flash_bwd_dq + flash_bwd_dkv, against the
        dense plain formula on the same inputs → largest differences. With
        `timed`, also the fused kernel's record at this shape: its time,
        the plain formula's, SDPA's backward alone under the same dense
        mask, and the bound."""
        import torch

        from determined_tpu_torch.ops import flash_attention as tfa

        args, kw = self.blocked_inputs(dtype, **shape)
        want = tfa.flash_bwd_blocked_plain(*args, **kw)
        errs = {}
        for kernel in BLOCKED:
            got = self.blocked_run(kernel, args, kw)
            torch.cuda.synchronize()
            errs[kernel] = self.hold_grads(f"{kernel} {name}", dtype, got,
                                           want)
            if kernel != "flash_bwd_blocked":  # deterministic sums
                again = self.blocked_run(kernel, args, kw)
                assert all(torch.equal(g, a) for g, a in zip(got, again)
                           if g is not None), \
                    f"{kernel} {name}: launches differ"
        self.report("kernels", f"blocked-backward {name} {str(dtype)[6:]}",
                    {f"{k}_max_abs_err": v for k, v in errs.items()})
        if not timed:
            return errs
        q, k, v, do = args[:4]
        b, s_q, h, d = q.shape
        s_k = k.shape[1]
        rows = torch.arange(s_q, device=self.dev)[:, None] + kw["kv_offset"]
        cols = torch.arange(s_k, device=self.dev)[None, :]
        mask = rows >= cols
        if kw["window"] is not None:
            mask = mask & (rows - cols < kw["window"])
        mask = mask[None].expand(b, s_q, s_k)
        if kw.get("segment_ids") is not None:
            mask = mask & (kw["segment_ids"][:, :, None]
                           == kw["kv_segment_ids"][:, None, :])
        live = int(mask.sum()) * h
        item = q.element_size()
        nbytes = 7 * q.numel() * item + 2 * 4 * b * s_q * h
        bound_ms, bound_by = self.bound(10.0 * d * live, nbytes, dtype)
        ms = self.time_ms(lambda: tfa.flash_bwd_blocked(*args, **kw))
        plain_ms = self.time_ms(
            lambda: tfa.flash_bwd_blocked_plain(*args, **kw), iters=5)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms = self.time_ms(self.sdpa_backward(
            qh, kh, vh, do, False, attn_mask=mask[:, None]))
        rec = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by,
                   max_abs_err=errs["flash_bwd_blocked"],
                   **self.rates(10.0 * d * live, ms, bound_ms))
        self.report("kernels", f"flash_bwd_blocked {name} "
                    f"{str(dtype)[6:]}", rec)
        return errs

    def hop_case(self, name, *, b, s_q, s_k, causal, bwd, kv_offset=0,
                 window=None, segs=None, seed=0, h=12, dlse=True,
                 kind="ring-hop"):
        """One ring hop's flash call at a shape phase context gives it
        (bf16, H `h` (12), D 64, q/k/v strided views of a [B, S, 3, H, D]
        projection, a nonzero lse cotangent as the merge passes back;
        ``dlse=False``: none, as a plain step's attention):
        flash_fwd and the backward kernels of its route (`bwd`), each held
        against its plain version (one head at a time) and timed beside it
        and beside SDPA under the same mask; the bound from this call's
        live pairs. `segs`: ([B, Sq], [B, Sk]) int32 ids → {kernel:
        record}."""
        import torch
        import torch.nn.functional as F

        from determined_tpu_torch.ops import flash_attention as tfa

        bf16 = torch.bfloat16
        d, item = 64, 2
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        q = self.randn((b, s_q, 3, h, d), bf16, gen)[:, :, 0]
        kv = self.randn((b, s_k, 3, h, d), bf16, gen)
        k, v = kv[:, :, 1], kv[:, :, 2]
        do = self.randn((b, s_q, h, d), bf16, gen)
        dl = (torch.randn((b, s_q, h), generator=gen, device=self.dev)
              if dlse else None)
        kw = dict(causal=causal, window=window, kv_offset=kv_offset)
        if segs is not None:
            kw.update(segment_ids=torch.as_tensor(segs[0], device=self.dev),
                      kv_segment_ids=torch.as_tensor(segs[1],
                                                     device=self.dev))

        def by_head(fn, *xs):
            parts = [fn(*(None if x is None else x[:, :, i:i + 1]
                          for x in xs), **kw) for i in range(h)]
            return tuple(torch.cat(p, dim=2) for p in zip(*parts))

        # the mask, for the live pairs and SDPA (None: SDPA's own)
        masked = segs is not None or window is not None or kv_offset or (
            causal and s_q != s_k)
        mask = None
        if masked:
            rows = torch.arange(s_q, device=self.dev)[:, None] + kv_offset
            cols = torch.arange(s_k, device=self.dev)[None, :]
            m = (rows >= cols) if causal else torch.ones_like(rows >= cols)
            if window is not None:
                m = m & (rows - cols < window)
            m = m[None].expand(b, s_q, s_k)
            if segs is not None:
                m = m & (kw["segment_ids"][:, :, None]
                         == kw["kv_segment_ids"][:, None, :])
            live = int(m.sum()) * h
            mask = m[:, None]
        else:
            live = b * h * (s_q * (s_q + 1) // 2 if causal else s_q * s_k)
        n_q, n_k = q.numel(), k.numel()
        rows_b = 4 * b * s_q * h
        big = s_q * s_k > 4096 * 4096
        it, plain_it = (3, 1) if big else (10, 3)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa_causal = causal and not masked
        recs = {}

        # forward
        plain_fwd = lambda: by_head(tfa.flash_fwd_plain, q, k, v)
        o_p, lse_p = plain_fwd()
        o_k, lse_k = tfa.flash_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        self.check(f"ring hop {name}", bf16, o_k, o_p, lse_k, lse_p)
        fwd_err = float((o_k.float() - o_p.float()).abs().max())
        del o_k, lse_k
        flops = 4.0 * d * live
        bound = self.bound(flops, item * (2 * n_q + 2 * n_k) + rows_b, bf16)
        ms = self.time_ms(lambda: tfa.flash_fwd(q, k, v, **kw), iters=it,
                          warmup=1)
        recs["flash_fwd"] = dict(
            ms=ms, plain_ms=self.time_ms(plain_fwd, iters=plain_it,
                                         warmup=0),
            library_ms=self.time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, is_causal=sdpa_causal),
                iters=it, warmup=1),
            bound_ms=bound[0], bound_by=bound[1], max_abs_err=fwd_err,
            **self.rates(flops, ms, bound[0]))

        # the backward of the hop's route, with the merge's lse cotangent
        delta = (do.float() * o_p.float()).sum(-1)
        args = (q, k, v, do, lse_p, delta, dl)
        del o_p
        plain_bwd = lambda: by_head(tfa.flash_bwd_blocked_plain, *args)
        want = plain_bwd()
        bwd_plain_ms = self.time_ms(plain_bwd, iters=plain_it, warmup=0)
        sdpa_bwd_ms = self.time_ms(self.sdpa_backward(
            qh, kh, vh, do, sdpa_causal, attn_mask=mask), iters=it, warmup=1)
        # FLOP per live pair / D and bytes written, by kernel
        work = {"flash_bwd_blocked": (10, n_q + 2 * n_k),
                "flash_bwd_dq": (6, n_q), "flash_bwd_dkv": (8, 2 * n_k)}
        for kname in bwd:
            got = self.blocked_run(kname, args, kw)
            torch.cuda.synchronize()
            err = self.hold_grads(f"{kname} ring hop {name}", bf16, got, want)
            del got
            per_pair, written = work[kname]
            flops = per_pair * d * live
            bound = self.bound(flops, item * (2 * n_q + 2 * n_k + written)
                               + 3 * rows_b, bf16)
            ms = self.time_ms(lambda: self.blocked_run(kname, args, kw),
                              iters=it, warmup=1)
            recs[kname] = dict(
                ms=ms, plain_ms=bwd_plain_ms,
                library_ms=(sdpa_bwd_ms if kname == "flash_bwd_blocked"
                            else None),
                sdpa_bwd_ms=sdpa_bwd_ms, bound_ms=bound[0],
                bound_by=bound[1], max_abs_err=err,
                **self.rates(flops, ms, bound[0]))
        shape = (f"B{b} s_q {s_q} s_k {s_k} H{h} D64 "
                 f"{'causal' if causal else 'full'}"
                 + (f" kv_offset {kv_offset}" if kv_offset else "")
                 + (f" window {window}" if window else "")
                 + (" packed" if segs is not None else "") + " bf16"
                 + (" dlse" if dlse else ""))
        for kname, rec in recs.items():
            rec["shape"] = shape
            self.report("kernels", f"{kind} {name} {kname}", rec)
        del args, want, q, k, v, kv, do, qh, kh, vh, mask
        torch.cuda.empty_cache()
        return recs

    def long_timed(self, seq, kernels):
        """`kernels` at a long-context training shape (B 1, H 12, D 64,
        causal, bf16, seq `seq`), each held against its plain version on
        the same inputs (the backward's dense formula one head at a time)
        and timed beside it: flash_fwd and flash_bwd_blocked against SDPA's
        forward and backward; flash_bwd_dq and flash_bwd_dkv with no
        library time (no single library call computes one pass alone;
        SDPA's whole backward is printed beside them). The same again at
        PLAIN_SEQ, where the plain backward runs on all heads at once."""
        import torch
        import torch.nn.functional as F

        from determined_tpu_torch.ops import flash_attention as tfa

        bf16 = torch.bfloat16
        h, d = 12, 64
        item = 2
        # FLOP per live pair / D, [B, S, H, D] outputs
        work = {"flash_bwd_blocked": (10, 3), "flash_bwd_dq": (6, 1),
                "flash_bwd_dkv": (8, 2)}
        recs = {name: dict(shape=f"B1 S{seq} H12 D64 causal bf16", seq=seq)
                for name in kernels}
        for s in (seq, PLAIN_SEQ):
            args, kw = self.blocked_inputs(bf16, b=1, s_q=s, s_k=s, seed=7)
            q, k, v, do = args[:4]
            live = h * s * (s + 1) // 2
            big = s == seq
            it, plain_it = (3, 1) if big else (10, 3)
            blk = dict(causal=True, block_q=min(1024, s),
                       block_k=min(1024, s))
            if big:
                plain_bwd = lambda: self.plain_by_head(args, kw)
            else:
                plain_bwd = lambda: tfa.flash_bwd_blocked_plain(*args, **kw)
            want = plain_bwd() if kernels != ("flash_fwd",) else None
            bwd_plain_ms = None
            for name in kernels:
                if name == "flash_fwd":
                    kernel = lambda: tfa.flash_fwd(q, k, v, causal=True)
                    if big:
                        plain = lambda: self.fwd_plain_by_head(q, k, v)
                    else:
                        plain = lambda: tfa.flash_fwd_plain(q, k, v,
                                                            causal=True)
                    o_k, lse_k = kernel()
                    o_p, lse_p = tfa.flash_attention_lse_plain(q, k, v,
                                                               **blk)
                    torch.cuda.synchronize()
                    self.check(f"flash_fwd long S{s}", bf16, o_k, o_p, lse_k,
                               lse_p)
                    o_p, lse_p = plain()
                    torch.cuda.synchronize()
                    self.check(f"flash_fwd long S{s} kernel-level", bf16, o_k,
                               o_p, lse_k, lse_p)
                    err = float((o_k.float() - o_p.float()).abs().max())
                    del o_k, lse_k, o_p, lse_p
                    plain_ms = self.time_ms(plain, iters=plain_it, warmup=1)
                    flops = 4.0 * d * live
                    nbytes = 4 * q.numel() * item + 4 * s * h
                else:
                    per_pair, outs = work[name]
                    kernel = lambda: self.blocked_run(name, args, kw)
                    got = kernel()
                    torch.cuda.synchronize()
                    err = self.hold_grads(f"{name} long S{s}", bf16, got,
                                          want)
                    if name == "flash_bwd_dq" and not big:
                        self.hold_dq_walk(f"S{s}", got[0], args, kw)
                    del got
                    if bwd_plain_ms is None:  # one formula for all three
                        bwd_plain_ms = self.time_ms(plain_bwd, iters=plain_it,
                                                    warmup=0 if big else 1)
                    plain_ms = bwd_plain_ms
                    flops = per_pair * d * live
                    # q, k, v, do and lse, delta read; the outputs written
                    nbytes = (4 + outs) * q.numel() * item + 2 * 4 * s * h
                ms = self.time_ms(kernel, iters=it, warmup=1)
                rec = recs[name]
                if not big:
                    rec.update(plain_seq=s, ms_at_plain_seq=ms,
                               plain_ms_at_plain_seq=plain_ms,
                               max_abs_err_at_plain_seq=err)
                    continue
                bound_ms, bound_by = self.bound(flops, nbytes, bf16)
                qh, kh, vh = (x.transpose(1, 2).contiguous()
                              for x in (q, k, v))
                if name == "flash_fwd":
                    lib = lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, is_causal=True)
                else:
                    lib = self.sdpa_backward(qh, kh, vh, do, True)
                sdpa_ms = self.time_ms(lib, iters=it, warmup=1)
                del qh, kh, vh, lib
                rec.update(
                    ms=ms, plain_ms=plain_ms, max_abs_err=err,
                    bound_ms=bound_ms, bound_by=bound_by,
                    library_ms=(sdpa_ms if name in ("flash_fwd",
                                                    "flash_bwd_blocked")
                                else None),
                    sdpa_ms=sdpa_ms,
                    **self.rates(flops, ms, bound_ms))
            if big and set(BLOCKED) <= set(kernels):
                # the two routes past the partials cap, like for like
                self.report("kernels", f"route-32k S{s}", dict(
                    fused_ms=self.time_ms(
                        lambda: self.blocked_run("flash_bwd_blocked", args,
                                                 kw), iters=it, warmup=1),
                    two_pass_ms=self.time_ms(
                        lambda: (self.blocked_run("flash_bwd_dq", args, kw),
                                 self.blocked_run("flash_bwd_dkv", args, kw)),
                        iters=it, warmup=1),
                    dq_ms=recs["flash_bwd_dq"]["ms"],
                    dkv_ms=recs["flash_bwd_dkv"]["ms"]))
            del args, q, k, v, do, want, plain_bwd
            torch.cuda.empty_cache()
        for name, rec in recs.items():
            self.report("kernels", f"{name} long-context", rec)
        return recs

    def hold_dq_walk(self, what, dq, args, kw):
        """The bf16 dq kernel's output against the plain copy of its own
        tile walk on the same inputs: the same ds roundings and fp32
        summation order by tile, so one bf16 ulp apart at most (rtol
        2^-7), with atol 2e-3 for values near zero, where ds rounded the
        other way (ex2 against exp) moves dq by up to ~5e-4 at S 4096 →
        the largest difference."""
        from determined_tpu_torch.ops import flash_attention as tfa

        walk = tfa._bwd_dq_walk_plain(*args, **kw)
        self.torch.testing.assert_close(dq.float(), walk.float(), atol=2e-3,
                                        rtol=2.0 ** -7,
                                        msg=f"flash_bwd_dq {what}: walk")
        err = float((dq.float() - walk.float()).abs().max())
        self.report("kernels", f"flash_bwd_dq {what} vs its walk",
                    dict(max_abs_err=err))
        return err

    def check(self, name, dtype, o_k, o_p, lse_k=None, lse_p=None):
        torch = self.torch
        if dtype == torch.bfloat16:
            torch.testing.assert_close(o_k.float(), o_p.float(), atol=2e-2,
                                       rtol=2e-2, msg=f"{name}: o")
            if lse_k is not None:
                torch.testing.assert_close(lse_k, lse_p, atol=1e-3, rtol=1e-6,
                                           msg=f"{name}: lse")
        else:
            torch.testing.assert_close(o_k, o_p, atol=1e-5, rtol=0,
                                       msg=f"{name}: o")
            if lse_k is not None:
                torch.testing.assert_close(lse_k, lse_p, atol=1e-5, rtol=1e-6,
                                           msg=f"{name}: lse")

    def report(self, phase, what, rec):
        nums = " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rec.items()
        )
        print(f"phase {phase}: {what} {nums} | card {self.card}", flush=True)

    # -- phase 4: the engine at full width ------------------------------------
    def engine_phase(self):
        import numpy as np
        import torch

        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.serving import build_engine

        eng = build_engine(ENGINE_CFG)  # the card, by default
        rng = np.random.default_rng(0)
        vocab = eng.model.config.vocab_size
        n_layers = eng.model.config.n_layers
        eng.start()
        try:
            warm = eng.submit(list(rng.integers(1, vocab, size=64)),
                              max_new_tokens=2)
            assert warm.result(timeout=600)["reason"] == "length"
            before = eng.stats()
            for k in _build.KERNELS.values():
                k.launches = 0
            t0 = time.perf_counter()
            first = [
                eng.submit(list(rng.integers(1, vocab, size=int(n))),
                           max_new_tokens=64 - 4 * i)
                for i, n in enumerate(rng.integers(64, 481, size=8))
            ]
            # late joiners arrive while the batch is mid-decode
            give_up = time.perf_counter() + 300
            while (len(first[0].tokens) < 8 and not first[0].finish_reason
                   and time.perf_counter() < give_up):
                time.sleep(0.005)
            late = [
                eng.submit(list(rng.integers(1, vocab, size=int(n))),
                           max_new_tokens=64, temperature=0.8 * (i == 3))
                for i, n in enumerate(rng.integers(64, 481, size=4))
            ]
            reqs = first + late
            results = [r.result(timeout=600) for r in reqs]
            wall = time.perf_counter() - t0
            after = eng.stats()
            launches = {k: v.launches for k, v in _build.KERNELS.items()}
        finally:
            eng.stop()
        reasons = [res.get("reason", res.get("error")) for res in results]
        assert reasons == ["length"] * len(reqs), reasons
        assert after["pages_in_use"] == 0, after
        for r, res in zip(reqs, results):
            assert len(res["tokens"]) == r.max_new_tokens
            assert all(0 <= t < vocab for t in res["tokens"])
        iters = after["decode_iterations"] - before["decode_iterations"]
        prefills = after["prefill_batches"] - before["prefill_batches"]
        assert launches["paged_attention"] == n_layers * iters, (launches, iters)
        assert launches["flash_fwd"] == n_layers * prefills, (launches, prefills)
        tokens = sum(len(res["tokens"]) for res in results)
        ttft = sorted((r.t_first_token - r.t_submit) * 1e3 for r in reqs)
        rec = dict(
            requests=len(reqs), tokens=tokens, prefills=prefills,
            decode_iterations=iters, tokens_per_s=tokens / wall,
            ttft_p50_ms=float(np.percentile(ttft, 50)),
            ttft_p99_ms=float(np.percentile(ttft, 99)),
            decode_iter_ms=(after["decode_seconds"] - before["decode_seconds"])
            * 1e3 / iters,
            flash_launches=launches["flash_fwd"],
            paged_launches=launches["paged_attention"],
        )
        self.report("engine", "gpt2-small bf16", rec)
        del eng
        torch.cuda.empty_cache()
        return launches

    # -- phase 5: greedy parity at fp32 -----------------------------------------
    def greedy_phase(self):
        import numpy as np
        import torch

        from determined_tpu_torch.models import gpt
        from determined_tpu_torch.serving import GenerationEngine, ServingConfig

        model = gpt.GPT(dataclasses.replace(gpt.small(), dtype=torch.float32))
        cfg = ServingConfig.from_dict({**ENGINE_CFG, "max_new_tokens": 32})
        rng = np.random.default_rng(1)
        prompts = [list(rng.integers(1, model.config.vocab_size, size=int(n)))
                   for n in rng.integers(64, 481, size=4)]
        streams = {}
        for kernel, env in (("paged", None), ("gather", "0")):
            if env is None:
                os.environ.pop("DTPU_PAGED_ATTN", None)
            else:
                os.environ["DTPU_PAGED_ATTN"] = env
            eng = GenerationEngine(model, None, cfg)
            assert eng.stats()["decode_kernel"] == kernel
            eng.start()
            try:
                reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
                res = [r.result(timeout=600) for r in reqs]
            finally:
                eng.stop()
            assert all(r["reason"] == "length" for r in res), res
            streams[kernel] = [r["tokens"] for r in res]
            del eng
        os.environ.pop("DTPU_PAGED_ATTN", None)
        near_ties = 0
        for prompt, paged, gather in zip(prompts, streams["paged"],
                                         streams["gather"]):
            first_tie = None
            for kernel, gen_toks in (("paged", paged), ("gather", gather)):
                seq = prompt + gen_toks
                logits = model.apply(torch.tensor([seq], device=model.device))
                top2 = logits[0].float().topk(2, dim=-1)
                for i in range(len(prompt) - 1, len(seq) - 1):
                    margin = float(top2.values[i, 0] - top2.values[i, 1])
                    if margin < NEAR_TIE:
                        near_ties += 1
                        if kernel == "paged" and first_tie is None:
                            first_tie = i - (len(prompt) - 1)
                        continue
                    assert int(top2.indices[i, 0]) == seq[i + 1], (
                        f"{kernel}: greedy divergence at position {i}"
                    )
            upto = len(paged) if first_tie is None else first_tie
            assert paged[:upto] == gather[:upto], (paged, gather)
        rec = dict(requests=len(prompts), tokens_per_stream=32,
                   near_ties=near_ties,
                   identical_streams=sum(p == g for p, g in
                                         zip(streams["paged"],
                                             streams["gather"])))
        self.report("greedy", "gpt2-small fp32 paged vs gather", rec)


    # -- phases 6 and 8-10: training through Trainer.fit ---------------------------
    def fit_counted(self, trial, steps, ctx=None, prepare=None,
                    trainer_kw=None, **fit_kw):
        """``Trainer(trial, **trainer_kw).fit`` to step `steps` on the card
        (more ``fit`` arguments in `fit_kw`; `prepare` sees the trainer
        first), with the launch counters set to 0 just before →
        (reports, per-step launch counts of the steps trained, the run's
        launch counts, peak GB, config)."""
        import numpy as np
        import torch

        from determined_tpu_torch import core
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.trainer import Batch, Trainer

        snapshots = []
        data = trial.build_training_data

        def counted():
            """Snapshots the launch counters as each step takes its batch."""
            for batch in data():
                snapshots.append({n: k.launches
                                  for n, k in _build.KERNELS.items()})
                yield batch

        trial.build_training_data = counted
        ctx = ctx or core._dummy_init()
        trainer = Trainer(trial, ctx, **(trainer_kw or {}))  # the card
        if prepare is not None:
            prepare(trainer)
        cfg = getattr(trainer.model, "config", None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in _build.KERNELS.values():
            k.launches = 0
        trainer.fit(max_length=Batch(steps), report_period=Batch(1), **fit_kw)
        launches = {n: k.launches for n, k in _build.KERNELS.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        snapshots.append(launches)
        reports = [m for g, _, m in ctx.train._reported if g == "training"]
        losses = [m.get("loss", float("nan")) for m in reports]
        assert all(np.isfinite(losses)), losses
        per_step = [{n: after[n] - before[n] for n in after}
                    for before, after in zip(snapshots, snapshots[1:])]
        # a resumed fit first discards the batches its checkpoint consumed
        resumed = len(per_step) - len(reports)
        assert len(reports) == steps - resumed, (reports, per_step)
        assert not any(v for d in per_step[:resumed] for v in d.values())
        per_step = per_step[resumed:]
        del trainer
        torch.cuda.empty_cache()
        return reports, per_step, launches, peak_gb, cfg

    def train_record(self, reports, launches, peak_gb, cfg, batch, seq,
                     warm):
        """Loss, step ms (median after `warm` steps), tokens/s, MFU and
        peak memory of a fit, plus the port kernels' launches."""
        import numpy as np

        step_ms = float(np.median(
            [1e3 / m["batches_per_second"] for m in reports[warm:]]))
        tokens_per_s = batch * seq / (step_ms / 1e3)
        return dict(
            steps=len(reports), batch=batch, seq=seq, layers=cfg.n_layers,
            loss_first=reports[0]["loss"], loss_last=reports[-1]["loss"],
            grad_norm_last=reports[-1]["grad_norm"], step_ms_median=step_ms,
            tokens_per_s=tokens_per_s,
            mfu=tokens_per_s * cfg.train_flops_per_token() / PEAK_BF16,
            max_memory_allocated_gb=peak_gb,
            **{f"{n}_launches": v for n, v in launches.items() if v},
        )

    def train_phase(self):
        from determined_tpu_torch.trainer.profile import RepeatedBatchTrial

        b, s = 8, 1024
        reports, per_step, launches, peak_gb, cfg = self.fit_counted(
            RepeatedBatchTrial(b, s), TRAIN_STEPS)
        losses = [m["loss"] for m in reports]
        assert losses[-1] < losses[0], losses
        n_layers = cfg.n_layers
        for i, step in enumerate(per_step):
            assert step["flash_fwd_mono"] == n_layers, (i, step)
            assert step["flash_bwd_mono"] == n_layers, (i, step)
            assert step["flash_fwd"] == 0, (i, step)
        rec = self.train_record(reports, launches, peak_gb, cfg, b, s, warm=2)
        self.train_step_ms = rec["step_ms_median"]  # phase exec's yardstick
        self.train_losses, self.train_peak_gb = losses, peak_gb  # phase mesh
        self.train_grad_norms = [m["grad_norm"] for m in reports]
        self.report("train", "gpt2-small bf16 remat=False", rec)
        return launches

    def train_long_phase(self):
        """The long16k rung at full width and depth: flash_fwd and the
        fused blocked backward only."""
        from determined_tpu_torch.trainer.profile import RUNGS, RepeatedBatchTrial

        b, cfg = RUNGS["long16k"]
        s = cfg.seq_len
        reports, per_step, launches, peak_gb, cfg = self.fit_counted(
            RepeatedBatchTrial(b, s, config=cfg), LONG_STEPS)
        losses = [m["loss"] for m in reports]
        assert losses[-1] < losses[0], losses
        self.long_losses = losses  # phase context's yardstick
        want = dict(flash_fwd=cfg.n_layers, flash_bwd_blocked=cfg.n_layers)
        for i, step in enumerate(per_step):
            got = {n: v for n, v in step.items() if v}
            assert got == want, (i, step)
        self.report("train-long", "gpt2-small bf16 long16k remat fused_loss",
                    self.train_record(reports, launches, peak_gb, cfg, b, s,
                                      warm=1))
        return launches

    def train_32k_phase(self):
        """The long32k rung at full width and depth: rematted attention
        (two forwards per layer and step) and the two-pass backward."""
        from determined_tpu_torch.trainer.profile import RUNGS, RepeatedBatchTrial

        b, cfg = RUNGS["long32k"]
        s = cfg.seq_len
        reports, per_step, launches, peak_gb, cfg = self.fit_counted(
            RepeatedBatchTrial(b, s, config=cfg), LONG32_STEPS)
        losses = [m["loss"] for m in reports]
        assert losses[-1] < losses[0], losses
        self.long32_losses = losses  # phase context's yardstick
        n = cfg.n_layers
        want = dict(flash_fwd=2 * n, flash_bwd_dq=n, flash_bwd_dkv=n)
        for i, step in enumerate(per_step):
            got = {k: v for k, v in step.items() if v}
            assert got == want, (i, step)
        self.report("train-32k", f"gpt2-small L{n} bf16 long32k "
                    "remat_attention fused_loss",
                    self.train_record(reports, launches, peak_gb, cfg, b, s,
                                      warm=1))
        return launches

    def train_packed_phase(self):
        """gpt.small() on packed documents at B=8 x 1024: the blocked
        forward and the fused blocked backward."""
        from determined_tpu_torch.trainer.profile import RepeatedBatchTrial

        b, s = 8, 1024
        from determined_tpu_torch.models import gpt

        trial = RepeatedBatchTrial(b, s, config=gpt.small())
        batch = packed_batch(b, s, 3, trial.config.vocab_size)

        def repeated():
            while True:
                yield batch

        trial.build_training_data = repeated
        reports, per_step, launches, peak_gb, cfg = self.fit_counted(
            trial, PACKED_STEPS)
        losses = [m["loss"] for m in reports]
        assert losses[-1] < losses[0], losses
        want = dict(flash_fwd=cfg.n_layers, flash_bwd_blocked=cfg.n_layers)
        for i, step in enumerate(per_step):
            got = {n: v for n, v in step.items() if v}
            assert got == want, (i, step)
        rec = self.train_record(reports, launches, peak_gb, cfg, b, s, warm=2)
        rec["documents"] = int(batch["segment_ids"].max(axis=1).sum())
        self.packed_losses = losses  # phase mesh's yardstick
        self.report("train-packed", "gpt2-small bf16 packed documents", rec)
        return launches

    # -- phase 11: save, verify and resume; serve the trained weights ----------
    def checkpoint_phase(self):
        """GPT-2-small (the train phase's trial) saves at step 2 and 4 of
        run A; run B resumes from step 2: its restored state must equal
        the step-2 snapshot bitwise and its losses at steps 3-4 run A's
        within 1e-3 relative. Then the trained parameters, saved as a
        parameter-only checkpoint, are served through build_engine with
        DTPU_SERVING_CHECKPOINT and must stream exactly what an engine
        built in memory from the same arrays streams."""
        import shutil
        import tempfile

        import numpy as np
        import torch

        from determined_tpu_torch import core
        from determined_tpu_torch.models import gpt
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.serving import (
            GenerationEngine,
            ServingConfig,
            build_engine,
            service,
        )
        from determined_tpu_torch.storage import shared
        from determined_tpu_torch.storage.base import file_digest
        from determined_tpu_torch.trainer import Batch
        from determined_tpu_torch.trainer import _checkpoint as ckpt_io
        from determined_tpu_torch.trainer.profile import RepeatedBatchTrial

        b, s, steps = 8, 1024, 4
        tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
        seconds = {"snapshot": [], "write_upload": [], "verify": [],
                   "load": []}
        snaps, restored = {}, {}
        real = {"snapshot": ckpt_io.snapshot_pytree,
                "verify": shared.verify_checkpoint_dir,
                "load": ckpt_io.load_pytree}

        def timed(key, fn, sync=False):
            def call(*args, **kwargs):
                if sync:  # the step before a snapshot is not its time
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                seconds[key].append(time.perf_counter() - t0)
                return out
            return call

        def snapshot(tree, **kw):
            snap = timed("snapshot", real["snapshot"], sync=True)(tree, **kw)
            snaps[int(snap["step"])] = snap
            return snap

        def watch_writer(trainer):
            submit = trainer._ckpt_writer.submit
            trainer._ckpt_writer.submit = lambda work: submit(
                timed("write_upload", work))

        def watch_restore(trainer):
            restore = trainer._restore_checkpoint

            def call(storage_id):
                restore(storage_id)
                restored.update(real["snapshot"](trainer._state_view()))
            trainer._restore_checkpoint = call

        ckpt_io.snapshot_pytree = snapshot
        shared.verify_checkpoint_dir = timed("verify", real["verify"])
        ckpt_io.load_pytree = timed("load", real["load"])
        try:
            ctx_a = core.init(checkpoint_storage=tmp)
            rep_a, per_a, launch_a, _, cfg = self.fit_counted(
                RepeatedBatchTrial(b, s), steps, ctx=ctx_a,
                prepare=watch_writer, checkpoint_period=Batch(2))
            ids = {}
            for sid in os.listdir(tmp):
                with open(os.path.join(tmp, sid, "metadata.json")) as f:
                    ids[json.load(f)["steps_completed"]] = sid
            assert sorted(ids) == [2, 4], ids
            ckpt_dir = os.path.join(tmp, ids[2])
            files = os.listdir(ckpt_dir)
            nbytes = sum(os.path.getsize(os.path.join(ckpt_dir, f))
                         for f in files)
            state_bytes = sum(a.nbytes for a in snaps[2].values())
            rep_b, per_b, launch_b, _, _ = self.fit_counted(
                RepeatedBatchTrial(b, s), steps,
                ctx=core.init(checkpoint_storage=tmp), prepare=watch_restore,
                latest_checkpoint=ids[2])
        finally:
            ckpt_io.snapshot_pytree = real["snapshot"]
            shared.verify_checkpoint_dir = real["verify"]
            ckpt_io.load_pytree = real["load"]
        try:
            assert sorted(restored) == sorted(snaps[2])
            for name, arr in snaps[2].items():
                assert restored[name].dtype == arr.dtype, name
                assert np.array_equal(restored[name], arr), name
            assert int(restored["step"]) == 2
            assert len(rep_b) == 2, rep_b
            worst = 0.0
            for ma, mb in zip(rep_a[2:], rep_b):
                rel = abs(mb["loss"] - ma["loss"]) / abs(ma["loss"])
                worst = max(worst, rel)
                assert rel <= 1e-3, (ma["loss"], mb["loss"])
            n = cfg.n_layers
            for i, step in enumerate(per_a + per_b):
                got = {k: v for k, v in step.items() if v}
                assert got == dict(flash_fwd_mono=n, flash_bwd_mono=n), (
                    i, step)

            # Serve run A's step-4 parameters from a parameter-only
            # checkpoint (root names, as save_pytree(params) writes them).
            serve_dir = os.path.join(tmp, "serve")
            tree = {name[len("params__"):]: arr
                    for name, arr in snaps[4].items()
                    if name.startswith("params__")}
            tree = ckpt_io.nest({k.replace("__", "."): v
                                 for k, v in tree.items()})
            written = ckpt_io.save_pytree(tree, serve_dir)
            shared.SharedFSStorageManager(tmp).commit_manifest(
                "serve", {r: file_digest(os.path.join(serve_dir, r))
                          for r in written})
            fp32_small = dataclasses.replace(gpt.small(), dtype=torch.float32)
            rng = np.random.default_rng(4)
            prompts = [list(rng.integers(1, fp32_small.vocab_size,
                                         size=int(k)))
                       for k in rng.integers(64, 481, size=4)]
            for k in _build.KERNELS.values():
                k.launches = 0
            # build_engine serves gpt.small() in bf16; the parity check
            # runs it at fp32, the greedy contract's dtype.
            small = service._MODEL_CONFIGS["small"]
            service._MODEL_CONFIGS["small"] = lambda: fp32_small
            os.environ["DTPU_SERVING_CHECKPOINT"] = serve_dir
            try:
                t0 = time.perf_counter()
                eng = build_engine(ENGINE_CFG)
                startup_s = time.perf_counter() - t0
            finally:
                service._MODEL_CONFIGS["small"] = small
                os.environ.pop("DTPU_SERVING_CHECKPOINT")
            from_ckpt = self.greedy_streams(eng, prompts, 32)
            serve_launch = {n: k.launches
                            for n, k in _build.KERNELS.items()}
            model = gpt.GPT(fp32_small)
            in_memory = self.greedy_streams(
                GenerationEngine(model, tree, ServingConfig.from_dict(
                    ENGINE_CFG)), prompts, 32)
            assert from_ckpt == in_memory, (from_ckpt, in_memory)
            assert serve_launch["flash_fwd"] > 0
            assert serve_launch["paged_attention"] > 0
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        gb = state_bytes / 1e9
        rec = dict(
            checkpoint_bytes=nbytes, checkpoint_files=len(files),
            state_bytes=state_bytes,
            snapshot_ms=seconds["snapshot"][0] * 1e3,
            snapshot_gb_per_s=gb / seconds["snapshot"][0],
            write_upload_ms=seconds["write_upload"][0] * 1e3,
            write_upload_gb_per_s=nbytes / 1e9 / seconds["write_upload"][0],
            verify_ms=seconds["verify"][0] * 1e3,
            verify_gb_per_s=nbytes / 1e9 / seconds["verify"][0],
            load_ms=seconds["load"][0] * 1e3,
            load_gb_per_s=gb / seconds["load"][0],
            loss_a=[round(m["loss"], 6) for m in rep_a],
            loss_b=[round(m["loss"], 6) for m in rep_b],
            worst_resumed_loss_rel=worst, restored_leaves=len(restored),
            serve_startup_ms=startup_s * 1e3,
            identical_streams=len(from_ckpt),
        )
        self.report("checkpoint", "gpt2-small bf16 save/verify/resume, "
                    "fp32 serve from checkpoint", rec)
        launches = {n: launch_a[n] + launch_b[n] + serve_launch[n]
                    for n in launch_a}
        del eng, model
        torch.cuda.empty_cache()
        return launches

    # -- phase 12: the pre-trained fixture ---------------------------------------
    def fixture_phase(self):
        """ensure_fixture on the card (trains it: the mono pair at fp32,
        seq 64), again (loads it, no training), then serves
        ``{"model": "fixture"}`` from its directory: the greedy
        continuation of each phrase must follow the phrase's cycle."""
        import shutil
        import tempfile

        import numpy as np
        import torch

        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.serving import build_engine, fixture

        tmp = tempfile.mkdtemp(prefix="chip-smoke-fixture-")
        losses = []
        fit = fixture._fit

        def recorded(model, steps):
            losses.append(fit(model, steps))
            return losses[-1]

        fixture._fit = recorded
        try:
            for k in _build.KERNELS.values():
                k.launches = 0
            t0 = time.perf_counter()
            _m, _p, path = fixture.ensure_fixture(tmp)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            train_launch = {n: k.launches for n, k in _build.KERNELS.items()}
            t0 = time.perf_counter()
            _m, _p, again = fixture.ensure_fixture(tmp)
            load_s = time.perf_counter() - t0
            assert again == path and len(losses) == 1, losses
            assert losses[0] <= 0.05, losses

            phrases = fixture.fixture_phrases()
            for k in _build.KERNELS.values():
                k.launches = 0
            os.environ["DTPU_SERVING_CHECKPOINT"] = path
            try:
                eng = build_engine({"model": "fixture"})
            finally:
                os.environ.pop("DTPU_SERVING_CHECKPOINT")
            streams = self.greedy_streams(eng, [p * 2 for p in phrases], 20)
            serve_launch = {n: k.launches for n, k in _build.KERNELS.items()}
        finally:
            fixture._fit = fit
            shutil.rmtree(tmp, ignore_errors=True)
        hits = sum(int(a == b) for p, got in zip(phrases, streams)
                   for a, b in zip(got, (p * 2)[:20]))
        accuracy = hits / (len(phrases) * 20)
        assert accuracy >= 0.95, (accuracy, streams)
        steps = fixture.TRAIN_STEPS
        assert train_launch["flash_fwd_mono"] == 2 * steps, train_launch
        assert train_launch["flash_bwd_mono"] == 2 * steps, train_launch
        assert serve_launch["flash_fwd"] > 0, serve_launch
        assert serve_launch["paged_attention"] > 0, serve_launch
        self.report("fixture", "tiny GPT fp32 pre-trained on the phrase "
                    "corpus, served from its checkpoint", dict(
                        train_steps=steps, final_loss=losses[0],
                        train_s=train_s, load_s=load_s,
                        phrases=len(phrases), continuation_accuracy=accuracy,
                        **{f"{n}_launches": v for n, v in
                           {**{k: train_launch[k] for k in
                               ("flash_fwd_mono", "flash_bwd_mono")},
                            **{k: serve_launch[k] for k in
                               ("flash_fwd", "paged_attention")}}.items()}))
        del eng
        return {n: train_launch[n] + serve_launch[n] for n in train_launch}

    def greedy_streams(self, eng, prompts, new_tokens):
        """Every prompt submitted before the engine starts (so two
        engines batch them alike), greedy → the token streams."""
        reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        eng.start()
        try:
            res = [r.result(timeout=600) for r in reqs]
        finally:
            eng.stop()
        assert all(r["reason"] == "length" for r in res), res
        return [r["tokens"] for r in res]

    # -- phases 13 and 14: the rest of serving ------------------------------------
    @contextlib.contextmanager
    def launch_geometry(self):
        """Record the geometry of every ``flash_fwd`` and
        ``paged_attention`` launch inside the block, as ("flash_fwd", b,
        s_q, s_k, kv_offset) and ("paged_attention", b, q_rows) tuples;
        the launches and their counts are the wrappers' own."""
        from determined_tpu_torch.ops import _build

        log = []
        kernels = (_build.FLASH_FWD, _build.PAGED_ATTENTION)

        def recorder(k):
            launch = type(k).launch

            def recorded(*args):
                launch(k, *args)
                if k is _build.FLASH_FWD:
                    log.append((k.name, args[9], args[11], args[12],
                                args[-3]))
                else:
                    log.append((k.name, args[10], args[11]))
            return recorded

        for k in kernels:
            k.launch = recorder(k)
        try:
            yield log
        finally:
            for k in kernels:
                del k.launch

    def serving_http_phase(self):
        """GPT-2-small bf16 behind ``GenerationServer``, driven by
        ``loadgen.drive`` over ``SERVING_HTTP_PROMPTS``: cache off + spec
        off, then cache on + spec ngram, the same request list."""
        import numpy as np
        import torch

        from determined_tpu_torch.models import gpt
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.serving import (
            GenerationEngine,
            GenerationServer,
            ServingConfig,
            loadgen,
        )

        model = gpt.GPT(gpt.small(), device=self.dev, seed=0)
        prompts = loadgen.zipf_prefix_prompts(**SERVING_HTTP_PROMPTS)
        n, m_new = len(prompts), SERVING_HTTP_NEW_TOKENS
        launches = {k: 0 for k in _build.KERNELS}
        recs = {}
        for name, extra in (
            ("cache-off spec-off", {}),
            ("cache-on spec-ngram", {"prefix_cache": "on", "speculation":
                                     SERVING_HTTP_SPEC}),
        ):
            eng = GenerationEngine(
                model, None, ServingConfig(**SERVING_HTTP_CFG, **extra))
            submitted, iter_s = [], []
            submit, decode_iter = eng.submit, eng._decode_iter

            def recording_submit(*a, _submit=submit, **kw):
                req = _submit(*a, **kw)
                submitted.append(req)
                return req

            def timed_iter(_decode_iter=decode_iter):
                t0 = time.perf_counter()
                _decode_iter()
                iter_s.append(time.perf_counter() - t0)

            eng.submit, eng._decode_iter = recording_submit, timed_iter
            eng.start()
            srv = GenerationServer(eng, host="127.0.0.1")
            srv.start()
            try:
                warm = loadgen.drive(srv.url, 4, 4, prompt_len=8,
                                     max_new_tokens=2, timeout_s=600.0)
                assert warm.completed == 4, [t.error for t in warm.traces]
                submitted.clear()
                iter_s.clear()
                for k in _build.KERNELS.values():
                    k.launches = 0
                with self.launch_geometry() as geometry:
                    report = loadgen.drive(srv.url, n, SERVING_HTTP_CONC,
                                           max_new_tokens=m_new,
                                           timeout_s=600.0, prompts=prompts)
                    torch.cuda.synchronize()
                counts = {k: v.launches for k, v in _build.KERNELS.items()}
                stats = eng.stats()
            finally:
                srv.stop()
                eng.stop()
            if eng.prefix_cache is not None:
                eng.prefix_cache.flush()
            assert eng.pool.pages_in_use == 0, eng.stats()
            assert report.completed == n, [t.error for t in report.traces]
            assert [r.finish_reason for r in submitted] == ["length"] * n
            assert all(t.tokens == m_new and len(t.token_ids) == m_new
                       and all(0 <= x < model.config.vocab_size
                               for x in t.token_ids)
                       for t in report.traces)
            for k, v in counts.items():
                launches[k] += v
            tail = sum(g == ("flash_fwd", 4, 512, 1536, 1024)
                       for g in geometry)
            verify = sum(g[0] == "paged_attention" and g[2] == 5
                         for g in geometry)
            spec = stats["speculation"]
            rec = dict(
                requests=n, tokens=report.total_tokens,
                tokens_per_s=report.tokens_per_sec,
                ttft_p50_ms=report.ttft_percentile_ms(50),
                ttft_p99_ms=report.ttft_percentile_ms(99),
                hit_rate=stats["cache_hit_rate"],
                proposed=spec["proposed_tokens"],
                accepted=spec["accepted_tokens"],
                decode_iterations=len(iter_s),
                decode_iter_ms_p50=float(np.median(iter_s)) * 1e3,
                flash_cached_tail_launches=tail,
                paged_q5_launches=verify,
                flash_launches=counts["flash_fwd"],
                paged_launches=counts["paged_attention"],
            )
            self.report("serving-http", f"gpt2-small bf16 {name}", rec)
            recs[name] = rec
            if name == "cache-off spec-off":
                self.serving_http_tps = rec["tokens_per_s"]
            del eng
        on = recs["cache-on spec-ngram"]
        assert on["hit_rate"] > 0 and on["proposed"] > 0, on
        assert on["flash_cached_tail_launches"] > 0, on
        assert on["paged_q5_launches"] > 0, on
        del model
        torch.cuda.empty_cache()
        return launches

    def parity_streams(self, model, cfg, prompts, new_tokens, waves=2):
        """Greedy streams of `prompts` through a fresh engine, submitted
        in `waves` (each waits for the one before, so a later wave can
        hit the prefix cache) → (streams, stats)."""
        from determined_tpu_torch.serving import GenerationEngine

        eng = GenerationEngine(model, None, cfg)
        eng.start()
        try:
            res = []
            step = -(-len(prompts) // waves)
            for i in range(0, len(prompts), step):
                reqs = [eng.submit(p, max_new_tokens=new_tokens)
                        for p in prompts[i:i + step]]
                res += [r.result(timeout=600) for r in reqs]
            stats = eng.stats()
        finally:
            eng.stop()
        assert all(r["reason"] == "length" for r in res), res
        return [r["tokens"] for r in res], stats

    def serving_parity_phase(self):
        """fp32 greedy streams of GPT-2-small across prefix cache and
        speculation settings, on the paged and the gather path; then the
        pre-trained fixture with speculation on and off."""
        import shutil
        import tempfile

        import torch

        from determined_tpu_torch.models import gpt
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.serving import ServingConfig, fixture, loadgen

        for k in _build.KERNELS.values():
            k.launches = 0
        model = gpt.GPT(dataclasses.replace(gpt.small(), dtype=torch.float32),
                        device=self.dev, seed=0)
        prompts = loadgen.zipf_prefix_prompts(**SERVING_HTTP_PROMPTS)[:6]
        configs = (("off", "off"), ("on", "off"), ("on", "ngram"))
        streams, hits, accepted = {}, 0, 0
        with self.launch_geometry() as geometry:
            for kernel, env in (("paged", None), ("gather", "0")):
                if env is None:
                    os.environ.pop("DTPU_PAGED_ATTN", None)
                else:
                    os.environ["DTPU_PAGED_ATTN"] = env
                for cache, spec in configs:
                    cfg = ServingConfig(
                        **SERVING_HTTP_CFG, prefix_cache=cache,
                        speculation={**SERVING_HTTP_SPEC, "mode": spec})
                    got, stats = self.parity_streams(model, cfg, prompts, 16)
                    assert stats["decode_kernel"] == kernel, stats
                    streams[(kernel, cache, spec)] = got
                    hits += stats.get("prefix_cache", {}).get("hits", 0)
                    accepted += stats["speculation"]["accepted_tokens"]
        os.environ.pop("DTPU_PAGED_ATTN", None)
        assert hits > 0, "the prefix cache never hit"
        shapes = dict(
            flash_cached_tail=("flash_fwd", 4, 512, 1536, 1024),
            flash_spec_gather=("flash_fwd", 8, 5, 1029, 1024),
            paged_q5=("paged_attention", 8, 5),
        )
        at_shape = {name: sum(g == shape for g in geometry)
                    for name, shape in shapes.items()}
        assert all(at_shape.values()), at_shape
        near_ties, identical = 0, 0
        base_key = ("paged", "off", "off")
        for j, prompt in enumerate(prompts):
            first_tie = {}
            for key, got in streams.items():
                seq = prompt + got[j]
                logits = model.apply(torch.tensor([seq], device=self.dev))
                top2 = logits[0].float().topk(2, dim=-1)
                first_tie[key] = len(got[j])
                for i in range(len(prompt) - 1, len(seq) - 1):
                    if float(top2.values[i, 0] - top2.values[i, 1]) < NEAR_TIE:
                        near_ties += 1
                        first_tie[key] = min(first_tie[key],
                                             i - (len(prompt) - 1))
                        continue
                    assert int(top2.indices[i, 0]) == seq[i + 1], (
                        f"{key}: greedy divergence at position {i}")
            base = streams[base_key][j]
            for key, got in streams.items():
                upto = min(first_tie[key], first_tie[base_key])
                assert got[j][:upto] == base[:upto], (key, got[j], base)
                identical += got[j] == base
        self.report("serving-parity", "gpt2-small fp32 cache x spec x "
                    "paged/gather", dict(
                        prompts=len(prompts), tokens_per_stream=16,
                        configs=len(streams), prefix_hits=hits,
                        accepted=accepted, near_ties=near_ties,
                        identical_streams=identical,
                        **{f"{n}_launches": v for n, v in at_shape.items()}))
        del model
        torch.cuda.empty_cache()

        tmp = tempfile.mkdtemp(prefix="chip-smoke-fixture-spec-")
        try:
            fmodel, _params, _path = fixture.ensure_fixture(tmp)
            prompts = loadgen.corpus_ngram_prompts(
                8, fixture.fixture_phrases(), seed=7)
            fixture_streams = {}
            for spec in ("off", "ngram"):
                cfg = ServingConfig(**FIXTURE_SPEC_CFG, speculation={
                    **SERVING_HTTP_SPEC, "mode": spec})
                fixture_streams[spec], stats = self.parity_streams(
                    fmodel, cfg, prompts, 24, waves=1)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        spec = stats["speculation"]
        assert fixture_streams["ngram"] == fixture_streams["off"], \
            fixture_streams
        assert spec["accepted_tokens"] > 0, spec
        self.report("serving-parity", "fixture fp32 spec ngram vs off",
                    dict(prompts=len(prompts), tokens_per_stream=24,
                         identical_streams=len(prompts),
                         proposed=spec["proposed_tokens"],
                         accepted=spec["accepted_tokens"],
                         acceptance_rate=spec["acceptance_rate"]))
        return {k: v.launches for k, v in _build.KERNELS.items()}

    # -- phase 7: one fp32 step, card against CPU ----------------------------------
    # -- phase 15: the health sentinel, the timeline, TensorBoard, profiler -----
    def train_health_phase(self):
        """The headline trial on an indexed stream (batch i from seed 1000
        + i mod 4; O(1) skip; every index recorded) under the health
        sentinel, the timeline, the profiler agent and TensorBoard: the
        non-finite drill (fit to 8, then to 16 with steps 9-10 poisoned:
        two skips, one rollback to step 8, the parameters bitwise the
        step-8 checkpoint's), the spike drill (to 24 with step 17 ×1e6:
        a second rollback), the ledger, scalars and card memory in the
        reports, a fresh trainer resuming the ledger; then the step ms
        with all of it on and all of it off, interleaved."""
        import math
        import shutil
        import tempfile

        import numpy as np
        import torch

        from determined_tpu_torch import core
        from determined_tpu_torch.common import faults
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.storage import shared
        from determined_tpu_torch.tensorboard import read_scalars
        from determined_tpu_torch.trainer import Batch, Trainer
        from determined_tpu_torch.trainer import _checkpoint as ckpt_io
        from determined_tpu_torch.trainer.profile import RepeatedBatchTrial

        class IndexedTrial(RepeatedBatchTrial):
            def __init__(self, record):
                super().__init__(8, 1024)
                self.record = record
                self.batches = {}

            def build_training_data(self):
                trial = self

                class Stream:
                    i = 0

                    def skip(self, n):
                        self.i += n

                    def __iter__(self):
                        return self

                    def __next__(self):
                        i, self.i = self.i, self.i + 1
                        trial.record.append(i)
                        if i % 4 not in trial.batches:
                            rng = np.random.default_rng(1000 + i % 4)
                            trial.batches[i % 4] = {"tokens": rng.integers(
                                0, trial.config.vocab_size,
                                (trial.batch, trial.config.seq_len),
                            ).astype(np.int32)}
                        return trial.batches[i % 4]

                return Stream()

        def plan(site, n):
            return faults.plan_active(faults.FaultPlan(
                {site: faults.FaultSpec(failures=n)}))

        def counts():
            return {n: k.launches for n, k in _build.KERNELS.items()}

        tmp = tempfile.mkdtemp(prefix="chip-smoke-health-")
        store, tb = os.path.join(tmp, "ckpt"), os.path.join(tmp, "tb")
        record, per_step, restores = [], [], []
        seconds = {"verify": [], "load": []}
        real = {"verify": shared.verify_checkpoint_dir,
                "load": ckpt_io.load_pytree}

        def timed(key):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                out = real[key](*args, **kwargs)
                seconds[key].append(time.perf_counter() - t0)
                return out
            return call

        ctx = core.init(checkpoint_storage=store)
        trainer = Trainer(IndexedTrial(record), ctx, health=TRAIN_HEALTH,
                          profiling=True, tensorboard_dir=tb)
        n_layers = trainer.model.config.n_layers
        step_fn, restore_fn = trainer._train_step, trainer._restore_with_fallback

        def counted_step(batch, poison=1.0):
            before = counts()
            out = step_fn(batch, poison)
            per_step.append({n: v - before[n] for n, v in counts().items()})
            return out

        def timed_restore(storage_id):
            torch.cuda.synchronize()  # the steps before are not its time
            t0 = time.perf_counter()
            restore_fn(storage_id)
            restores.append(time.perf_counter() - t0)
            if len(restores) == 1:
                restored.update(ckpt_io.snapshot_pytree(trainer._state_view()))

        def drop_older(keep):
            """Delete every checkpoint but `keep` (at most three of 1.49
            GB live on the disk at once)."""
            for sid in os.listdir(store):
                if sid not in (keep, "tensorboard"):
                    ctx.checkpoint.delete(sid)

        restored = {}
        trainer._train_step = counted_step
        trainer._restore_with_fallback = timed_restore
        shared.verify_checkpoint_dir = timed("verify")
        ckpt_io.load_pytree = timed("load")
        period = dict(report_period=Batch(1), checkpoint_period=Batch(4))
        try:
            torch.cuda.synchronize()
            for k in _build.KERNELS.values():
                k.launches = 0
            # 1. the non-finite drill
            trainer.fit(max_length=Batch(8), **period)
            at8 = ckpt_io.snapshot_pytree(trainer._state_view())
            assert record == list(range(8)), record
            drop_older(trainer._last_ckpt_id)
            with plan("train.nonfinite", 2):
                trainer.fit(max_length=Batch(16), **period)
            assert (trainer.steps_skipped, trainer.rollbacks,
                    trainer._data_offset) == (2, 1, 2), trainer._data_offset
            # 0..7, then 8 and 9 (poisoned), then 10..17 for steps 9-16
            assert record == list(range(18)), record
            assert sorted(restored) == sorted(at8)
            for name, arr in at8.items():
                assert np.array_equal(restored[name], arr), name
            del at8
            restored.clear()
            drop_older(trainer._last_ckpt_id)
            # 2. the spike drill
            with plan("train.spike", 1):
                trainer.fit(max_length=Batch(24), **period)
            assert (trainer.steps_skipped, trainer.rollbacks,
                    trainer._data_offset) == (2, 2, 3)
            assert record == list(range(27)), record
            final = trainer._last_ckpt_id
            drop_older(final)
        finally:
            shared.verify_checkpoint_dir = real["verify"]
            ckpt_io.load_pytree = real["load"]
        try:
            reports = [(s, m) for g, s, m in ctx.train._reported
                       if g == "training"]
            assert len(reports) == 8 + 10 + 9 == len(per_step), len(reports)
            for s, m in reports:
                assert all(math.isfinite(v) for v in m.values()), (s, m)
            skipped = [s for s, m in reports if m["sentinel_skipped"]]
            assert skipped == [9, 10], skipped
            losses = [m["loss"] for _, m in reports if "loss" in m]
            assert losses[-1] < losses[0], losses
            assert max(losses) > 1e5  # the spiked step, applied and reported
            for i, step in enumerate(per_step):
                got = {n: v for n, v in step.items() if v}
                assert got == dict(flash_fwd_mono=n_layers,
                                   flash_bwd_mono=n_layers), (i, step)

            # 3. the ledger, the profiler's samples, TensorBoard
            prof = [m for g, _, m in ctx.train._reported if g == "profiling"]
            ledger = [m for m in prof if "goodput_pct" in m]
            samples = [m for m in prof if "memory_used_bytes" in m]
            assert len(ledger) == len(reports)
            for m in ledger:
                frac = sum(m[f"{p}_frac"] for p in
                           ("data_wait", "h2d_put", "report", "checkpoint",
                            "step"))
                assert abs(frac - 1.0) <= 1e-6, m
            last = ledger[-1]
            assert 0.0 < last["goodput_pct"] < 100.0, last
            assert last["rollback_lost_s"] > 0 and last["ledger_rollbacks"] == 2
            flops = {m["step_flops"] for m in ledger if "step_flops" in m}
            assert flops == {trainer.model.train_flops_per_token() * 8 * 1024}
            state_bytes = sum(p.numel() * 4 * 3 for p in trainer._params)
            assert samples and max(m["device0_bytes_in_use"]
                                   for m in samples) > state_bytes, samples
            (tb_file,) = os.listdir(tb)
            tb_losses = [(e["step"], e["scalars"]["loss"])
                         for e in read_scalars(os.path.join(tb, tb_file))
                         if "loss" in e["scalars"]]
            want = [(s, m["loss"]) for s, m in reports if "loss" in m]
            assert [s for s, _ in tb_losses] == [s for s, _ in want]
            for (s, got), (_, loss) in zip(tb_losses, want):
                assert abs(got - loss) <= 1e-6 * abs(loss), (s, got, loss)
            synced = os.listdir(os.path.join(store, "tensorboard", "local"))
            assert synced == [tb_file], synced
            trainer._train_step = step_fn
            del trainer
            torch.cuda.empty_cache()

            # a fresh trainer resumes the final checkpoint and its ledger
            resumed_record = []
            ctx2 = core.init(checkpoint_storage=store)
            resumed = Trainer(IndexedTrial(resumed_record), ctx2,
                              health=TRAIN_HEALTH)
            resumed.fit(max_length=Batch(25), report_period=Batch(1),
                        latest_checkpoint=final)
            assert resumed_record == [27], resumed_record
            resumed_ledger = [m for g, _, m in ctx2.train._reported
                              if g == "profiling"][-1]
            assert resumed_ledger["ledger_restarts"] == 1, resumed_ledger
            assert resumed_ledger["ledger_rollbacks"] == 2, resumed_ledger
            launches = counts()  # the drills and the resumed step
            del resumed
            torch.cuda.empty_cache()

            # 4. cost: all on against all off, interleaved
            cost = self.health_cost()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        rec = dict(
            steps=len(reports), rollbacks=2, steps_skipped=2, data_offset=3,
            records=len(record), loss_first=losses[0], loss_last=losses[-1],
            goodput_pct=last["goodput_pct"],
            rollback_lost_s=last["rollback_lost_s"],
            productive_s=last["productive_s"],
            step_frac=last["total_step_frac"],
            data_wait_frac=last["total_data_wait_frac"],
            checkpoint_frac=last["total_checkpoint_frac"],
            step_flops=last["step_flops"],
            device0_bytes_in_use_max=max(m["device0_bytes_in_use"]
                                         for m in samples),
            device0_hbm_util_max=max(m["device0_hbm_util"] for m in samples),
            profiler_reports=len(samples), tb_losses=len(tb_losses),
            resumed_restarts=resumed_ledger["ledger_restarts"],
            **{f"restore{i + 1}_ms": s * 1e3 for i, s in enumerate(restores)},
            **{f"verify{i + 1}_ms": s * 1e3
               for i, s in enumerate(seconds["verify"])},
            **{f"load{i + 1}_ms": s * 1e3
               for i, s in enumerate(seconds["load"])},
            **cost,
            **{f"{n}_launches": v for n, v in launches.items() if v},
        )
        self.report("train-health", "gpt2-small bf16 B8x1024 sentinel "
                    "timeline profiler tensorboard", rec)
        return launches

    def health_cost(self):
        """Median step ms of the headline trial with the sentinel (spike
        detector on), the timeline, the profiler agent and TensorBoard all
        on, and all off (DTPU_TIMELINE=0, default health, no profiling),
        in HEALTH_COST_ROUNDS interleaved rounds of HEALTH_COST_STEPS."""
        import shutil
        import tempfile

        import numpy as np
        import torch

        from determined_tpu_torch import core
        from determined_tpu_torch.profiler import ProfilerAgent
        from determined_tpu_torch.trainer import Batch, Trainer
        from determined_tpu_torch.trainer.profile import RepeatedBatchTrial

        tb = tempfile.mkdtemp(prefix="chip-smoke-health-tb-")
        os.environ["DTPU_TIMELINE"] = "0"
        try:
            off = Trainer(RepeatedBatchTrial(8, 1024), core._dummy_init())
        finally:
            del os.environ["DTPU_TIMELINE"]
        on = Trainer(RepeatedBatchTrial(8, 1024), core._dummy_init(),
                     health=TRAIN_HEALTH, profiling=True, tensorboard_dir=tb)
        assert not off.timeline.enabled and on.timeline.enabled
        ms = {"on": [], "off": []}
        for trainer in (on, off):  # warm-up, not counted
            trainer.fit(max_length=Batch(2), report_period=Batch(1))
        for r in range(HEALTH_COST_ROUNDS):
            for name in (("on", "off") if r % 2 == 0 else ("off", "on")):
                trainer = on if name == "on" else off
                if trainer is on:  # the agent samples during one fit only
                    on._profiler = ProfilerAgent(on.core.train)
                n = len(trainer.core.train._reported)
                trainer.fit(max_length=Batch(trainer.steps_completed
                                             + HEALTH_COST_STEPS),
                            report_period=Batch(1))
                ms[name] += [1e3 / m["batches_per_second"] for g, _, m in
                             trainer.core.train._reported[n:]
                             if g == "training"]
        del on, off
        torch.cuda.empty_cache()
        shutil.rmtree(tb, ignore_errors=True)
        assert len(ms["on"]) == len(ms["off"]) == \
            HEALTH_COST_ROUNDS * HEALTH_COST_STEPS
        med_on, med_off = (float(np.median(ms[k])) for k in ("on", "off"))
        return dict(step_ms_on=med_on, step_ms_off=med_off,
                    step_ms_on_minus_off=med_on - med_off,
                    cost_rounds=HEALTH_COST_ROUNDS,
                    cost_steps=HEALTH_COST_STEPS)

    # -- phase 16: the exec layer, off the cluster -------------------------------
    def harness_run(self, entrypoint, hparams, config, task, store, **env):
        """``harness.run(entrypoint)`` in this process with the trial
        variables set as the agent sets them (no ``DTPU_JAX_PLATFORM``:
        the card), the launch counters set to 0 just before and read just
        after → (exit code, per-step launches, the run's launches, its
        training scalars by step from the tfevents it wrote, wall s)."""
        import glob
        import tempfile

        import torch

        from determined_tpu_torch.exec import harness
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.tensorboard import read_scalars
        from determined_tpu_torch.trainer import Trainer

        env = {"DTPU_TRIAL_ID": "1", "DTPU_TASK_ID": task,
               "DTPU_HPARAMS": json.dumps(hparams),
               "DTPU_EXPERIMENT_CONFIG": json.dumps(config),
               "DTPU_CHECKPOINT_STORAGE": json.dumps(
                   {"type": "shared_fs", "host_path": store}), **env}
        keys = {k for k in os.environ if k.startswith("DTPU_")} | set(env)
        saved = {k: os.environ.get(k) for k in keys}
        per_step = []
        step_fn = Trainer._train_step

        def counted_step(trainer, batch, poison=1.0):
            before = {n: k.launches for n, k in _build.KERNELS.items()}
            out = step_fn(trainer, batch, poison)
            per_step.append({n: k.launches - before[n]
                             for n, k in _build.KERNELS.items()})
            return out

        for k in keys:
            os.environ.pop(k, None)
        os.environ.update(env)
        Trainer._train_step = counted_step
        try:
            torch.cuda.synchronize()
            for k in _build.KERNELS.values():
                k.launches = 0
            t0 = time.perf_counter()
            rc = harness.run(entrypoint)
            wall = time.perf_counter() - t0
            launches = {n: k.launches for n, k in _build.KERNELS.items()}
        finally:
            Trainer._train_step = step_fn
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        torch.cuda.empty_cache()
        scalars = {}
        tb = os.path.join(tempfile.gettempdir(), f"dtpu-tb-{task}")
        for path in glob.glob(os.path.join(tb, "events.out.tfevents.*")):
            for ev in read_scalars(path):
                if "batches_per_second" in ev["scalars"]:
                    scalars[ev["step"]] = ev["scalars"]
        return rc, per_step, launches, scalars, wall

    def exec_phase(self):
        """The exec layer off the cluster on the card: harness.run of the
        built-in SyntheticTrial (gpt2-small, B 8 x 1024, 8 batches,
        checkpoints at 4 and 8), resumed from step 4; the GPT-2 pretrain
        trial over two uint16 shards on the native loader; the vision
        trials; then ``python -m determined_tpu_torch.exec.harness`` in a
        subprocess, clean and crashing."""
        import shutil
        import subprocess as sp
        import tempfile

        import numpy as np
        import torch

        from determined_tpu_torch import core
        from determined_tpu_torch.data import lm_dataset, native
        from determined_tpu_torch.data import write_token_shard
        from determined_tpu_torch.exec.builtin_trials import SyntheticTrial
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.storage.base import verify_checkpoint_dir
        from determined_tpu_torch.trainer import Batch, Trainer

        builtin = "determined_tpu_torch.exec.builtin_trials"
        tmp = tempfile.mkdtemp(prefix="chip-smoke-exec-")
        store = os.path.join(tmp, "ckpt")
        tag = f"chip-smoke-{os.getpid()}"
        tasks = [f"{tag}-{n}" for n in ("a", "b", "gpt2", "mlp", "cnn")]
        total = {n: 0 for n in _build.KERNELS}
        rec = {}

        def checkpoints():
            """{storage id: steps} (the store also holds ``tensorboard/``)"""
            out = {}
            for d in os.listdir(store):
                md = os.path.join(store, d, "metadata.json")
                if os.path.exists(md):
                    with open(md) as f:
                        out[d] = json.load(f)["steps_completed"]
            return out

        def mono_only(per_step, n_steps, what):
            assert len(per_step) == n_steps, (what, len(per_step))
            for i, step in enumerate(per_step):
                for name, n in step.items():
                    want = 12 if name in ("flash_fwd_mono",
                                          "flash_bwd_mono") else 0
                    assert n == want, (what, i, name, n)

        def step_ms(scalars, skip):
            """Median of 1e3 / batches_per_second over the steps not in
            `skip` (warm-up, and the step whose window holds a save)."""
            return float(np.median([1e3 / m["batches_per_second"]
                                    for s, m in scalars.items()
                                    if s not in skip]))

        def add(launches):
            for n, v in launches.items():
                total[n] += v

        try:
            # 1. gpt2-small through the harness, checkpoints at 4 and 8
            hp = {"model": "gpt2-small", "batch_size": 8, "seq_len": 1024,
                  "lr": 3e-4}
            cfg = {"searcher": {"name": "single", "metric": "loss",
                                "max_length": {"batches": 8}},
                   "min_checkpoint_period": {"batches": 4},
                   "scheduling_unit": 1}
            rc, per_step, launches, run_a, wall_a = self.harness_run(
                f"{builtin}:SyntheticTrial", hp, cfg, tasks[0], store)
            assert rc == 0, rc
            mono_only(per_step, 8, "gpt2-small")
            add(launches)
            assert sorted(run_a) == list(range(1, 9)), sorted(run_a)
            losses_a = [run_a[s]["loss"] for s in range(1, 9)]
            assert all(np.isfinite(losses_a)), losses_a
            by_step = {s: c for c, s in checkpoints().items()}
            assert sorted(by_step) == [4, 8], by_step
            for ckpt in by_step.values():
                with open(os.path.join(store, ckpt, "manifest.json")) as f:
                    assert json.load(f)["files"], ckpt
            assert verify_checkpoint_dir(os.path.join(store, by_step[8]))
            # resumed from step 4 through DTPU_LATEST_CHECKPOINT
            rc, per_step, launches, run_b, wall_b = self.harness_run(
                f"{builtin}:SyntheticTrial", hp, cfg, tasks[1], store,
                DTPU_LATEST_CHECKPOINT=by_step[4])
            assert rc == 0, rc
            mono_only(per_step, 4, "gpt2-small resumed")
            add(launches)
            assert sorted(run_b) == [5, 6, 7, 8], sorted(run_b)
            resume_rel = max(abs(run_b[s]["loss"] - run_a[s]["loss"])
                             / abs(run_a[s]["loss"]) for s in range(5, 9))
            assert resume_rel <= 1e-3, resume_rel
            harness_ms = step_ms(run_a, skip={1, 2, 5})
            # the same trial through Trainer.fit directly (no harness, no
            # checkpoints), read over the same steps
            ctx = core._dummy_init()
            trainer = Trainer(SyntheticTrial(hp), ctx)
            for k in _build.KERNELS.values():
                k.launches = 0
            trainer.fit(max_length=Batch(8), report_period=Batch(1))
            add({n: k.launches for n, k in _build.KERNELS.items()})
            direct = {step: m for _, step, m in ctx.train._reported
                      if "batches_per_second" in m}
            direct_ms = step_ms(direct, skip={1, 2, 5})
            del trainer, ctx
            torch.cuda.empty_cache()
            rec.update(
                gpt2_rc=0, gpt2_steps=8, gpt2_loss_first=losses_a[0],
                gpt2_loss_last=losses_a[-1], gpt2_wall_s=wall_a,
                checkpoints="4,8", resumed_rc=0, resumed_wall_s=wall_b,
                resumed_loss_max_rel=resume_rel,
                harness_step_ms_median=harness_ms,
                direct_step_ms_median=direct_ms,
                harness_minus_direct_ms=harness_ms - direct_ms,
                train_phase_step_ms_median=self.train_step_ms,
                harness_minus_train_ms=harness_ms - self.train_step_ms)
            self.exec_step_ms = harness_ms

            # 2. the GPT-2 pretrain trial on the native loader
            rng = np.random.default_rng(11)
            for i in range(2):
                write_token_shard(os.path.join(tmp, f"tokens-{i}.bin"),
                                  rng.integers(0, 50257, 4_000_000))
            shards = [os.path.join(tmp, "tokens-*.bin")]
            assert native.load_library() is not None, "native loader"
            data = lm_dataset(shards, 8, 1024, 50304, seed=0)
            assert data.native
            t0 = time.perf_counter()
            for _ in range(200):
                next(data)
            loader_bps = 200 / (time.perf_counter() - t0)
            data.close()
            hp = {"model_config": {}, "batch_size": 8, "token_shards": shards,
                  "lr": 3e-4, "warmup_steps": 2, "decay_steps": 100}
            cfg = {"searcher": {"name": "single", "metric": "loss",
                                "max_length": {"batches": 6}},
                   "scheduling_unit": 1}
            rc, per_step, launches, run, wall = self.harness_run(
                "determined_tpu_torch.examples.gpt2_trial:GPT2PretrainTrial",
                hp, cfg, tasks[2], store)
            assert rc == 0, rc
            mono_only(per_step, 6, "gpt2 pretrain")
            add(launches)
            losses = [run[s]["loss"] for s in sorted(run)]
            assert len(losses) == 6 and all(np.isfinite(losses)), losses
            pretrain_ms = step_ms(run, skip={1, 2})
            rec.update(pretrain_rc=0, pretrain_steps=6,
                       pretrain_loss_last=losses[-1], pretrain_wall_s=wall,
                       pretrain_step_ms_median=pretrain_ms,
                       pretrain_steps_per_s=1e3 / pretrain_ms,
                       loader_batches_per_s=loader_bps)

            # 3. the vision trials (library convolutions and matmuls; no
            # port kernel)
            cfg = {"searcher": {"name": "single", "metric": "loss",
                                "max_length": {"batches": 60}},
                   "scheduling_unit": 10}
            rc, per_step, launches, run, wall = self.harness_run(
                f"{builtin}:LearnableTrial",
                {"model": "mnist-mlp", "batch_size": 128, "lr": 3e-3}, cfg,
                tasks[3], store)
            assert rc == 0 and len(per_step) == 60, (rc, len(per_step))
            assert not any(launches.values()), launches
            losses = [run[s]["loss"] for s in sorted(run)]
            assert losses[-1] < 0.75 * losses[0], losses
            rec.update(mlp_rc=0, mlp_loss_first=losses[0],
                       mlp_loss_last=losses[-1], mlp_wall_s=wall)
            cfg = {"searcher": {"name": "single", "metric": "loss",
                                "max_length": {"batches": 4}},
                   "scheduling_unit": 1}
            rc, per_step, launches, run, wall = self.harness_run(
                f"{builtin}:SyntheticTrial",
                {"model": "cifar-cnn", "batch_size": 32}, cfg, tasks[4],
                store)
            assert rc == 0 and len(per_step) == 4, (rc, len(per_step))
            assert not any(launches.values()), launches
            losses = [run[s]["loss"] for s in sorted(run)]
            assert len(losses) == 4 and all(np.isfinite(losses)), losses
            rec.update(cnn_rc=0, cnn_loss_last=losses[-1], cnn_wall_s=wall)

            # 4. the module launch in a subprocess, as the agent spawns it
            env = {k: v for k, v in os.environ.items()
                   if not k.startswith("DTPU_")}
            env.update(
                DTPU_TRIAL_ID="2", TMPDIR=tmp,
                DTPU_CHECKPOINT_STORAGE=json.dumps(
                    {"type": "shared_fs", "host_path": store}),
                DTPU_EXPERIMENT_CONFIG=json.dumps(
                    {"searcher": {"name": "single", "metric": "loss",
                                  "max_length": {"batches": 8}},
                     "tensorboard": False}))
            root = os.path.dirname(os.path.abspath(__file__))
            for trial, hparams, want in (
                    ("SyntheticTrial", {"model": "mnist-mlp",
                                        "batch_size": 32}, 0),
                    ("CrashingTrial", {"crash_message":
                                       "chip smoke: deliberate crash"}, 1)):
                t0 = time.perf_counter()
                out = sp.run(
                    [sys.executable, "-m", "determined_tpu_torch.exec.harness"],
                    cwd=root, capture_output=True, text=True, timeout=300,
                    env=dict(env, DTPU_ENTRYPOINT=f"{builtin}:{trial}",
                             DTPU_HPARAMS=json.dumps(hparams)))
                wall = time.perf_counter() - t0
                assert out.returncode == want, (trial, out.returncode,
                                                out.stderr[-3000:])
                if want:
                    assert "trial failed" in out.stderr, out.stderr[-3000:]
                    assert "chip smoke: deliberate crash" in out.stderr
                rec[f"subprocess_{trial}_rc"] = out.returncode
                rec[f"subprocess_{trial}_wall_s"] = wall
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            for task in tasks:
                shutil.rmtree(os.path.join(tempfile.gettempdir(),
                                           f"dtpu-tb-{task}"),
                              ignore_errors=True)
        rec.update({f"{n}_launches": v for n, v in total.items() if v})
        self.report("exec", "harness off the cluster: gpt2-small B8x1024 "
                    "+ resume, GPT-2 pretrain on shards, mnist-mlp, "
                    "cifar-cnn, module launch", rec)
        return total

    def counted_launch(self, module, args, env, out, log):
        """``python -m <module> <args>`` in a subprocess, through
        ``COUNTING_BOOT`` (its launch counts land in `out` at exit), with
        stdout and stderr in `log`."""
        import subprocess as sp

        root = os.path.dirname(os.path.abspath(__file__))
        with open(log, "w") as f:
            return sp.Popen([sys.executable, "-c", COUNTING_BOOT, module, out,
                             *args], cwd=root, env=env, stdout=f,
                            stderr=sp.STDOUT)

    @staticmethod
    def wait_or_dump(proc, timeout, log, what):
        """`proc`'s exit code within `timeout` seconds; past it, its
        Python stacks (SIGUSR1, ``COUNTING_BOOT``) and the tail of its
        `log` in the AssertionError, so that a hang says where it hung."""
        import signal
        import subprocess as sp

        try:
            return proc.wait(timeout=timeout)
        except sp.TimeoutExpired:
            proc.send_signal(signal.SIGUSR1)
            time.sleep(3.0)
            with open(log) as f:
                tail = f.read()[-12000:]
            raise AssertionError(
                f"{what} did not exit within {timeout} s; its stacks and "
                f"log:\n{tail}") from None

    def cluster_phase(self):
        """The exec layer on the cluster against ``StandInMaster``: a
        gpt2-small trial preempted at step 8 and resumed to 12, then a
        GPT-2-small replica driven through its proxy registration and
        preempted."""
        import http.client
        import secrets
        import shutil
        import tempfile
        import threading

        import numpy as np

        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.serving import loadgen
        from determined_tpu_torch.storage.base import verify_checkpoint_dir

        t_phase = time.perf_counter()
        builtin = "determined_tpu_torch.exec.builtin_trials"
        tmp = tempfile.mkdtemp(prefix="chip-smoke-cluster-")
        store = os.path.join(tmp, "ckpt")
        master = StandInMaster(op_length=CLUSTER_STEPS)
        master.capture_at_step, master.capture_steps = 4, 1
        master.preempt_after_step = 8
        token = secrets.token_hex(16)
        trace_id = secrets.token_hex(16)
        hp = {"model": "gpt2-small", "batch_size": 8, "seq_len": 1024,
              "lr": 3e-4}
        cfg = {"searcher": {"name": "single", "metric": "loss",
                            "max_length": {"batches": CLUSTER_STEPS}},
               "min_checkpoint_period": {"batches": 4},
               "scheduling_unit": 1}
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DTPU_")}
        env.update(TMPDIR=tmp, DTPU_MASTER=master.url,
                   DTPU_SESSION_TOKEN=token, DTPU_CLUSTER_ID="chip-smoke",
                   DTPU_PROFILE="1", DTPU_PROFILE_WINDOW_S="1",
                   DTPU_PROFILE_HZ="49",
                   DTPU_LOG_SHIP="1")
        trial_env = dict(
            env, DTPU_TASK_ID="trial-1", DTPU_TASK_TYPE="TRIAL",
            DTPU_TRIAL_ID="1", DTPU_EXPERIMENT_ID="1", DTPU_TRIAL_SEED="0",
            DTPU_HPARAMS=json.dumps(hp),
            DTPU_EXPERIMENT_CONFIG=json.dumps(dict(cfg, tensorboard=False)),
            DTPU_CHECKPOINT_STORAGE=json.dumps(
                {"type": "shared_fs", "host_path": store}),
            DTPU_ENTRYPOINT=f"{builtin}:SyntheticTrial")
        total = {n: 0 for n in _build.KERNELS}
        rec = {}
        replica = None

        def mono_only(per_step, n_steps, what):
            assert len(per_step) == n_steps, (what, len(per_step))
            for i, step in enumerate(per_step):
                for name, n in step.items():
                    want = 12 if name in ("flash_fwd_mono",
                                          "flash_bwd_mono") else 0
                    assert n == want, (what, i, name, n)

        def launch_trial(run, **extra):
            parent = secrets.token_hex(8)
            out = os.path.join(tmp, f"trial-{run}.json")
            t0 = time.perf_counter()
            proc = self.counted_launch(
                "determined_tpu_torch.exec.harness", [], dict(
                    trial_env, DTPU_ALLOCATION_ID=f"1.1.{run}",
                    DTPU_TRIAL_RUN_ID=str(run),
                    DTPU_TRACEPARENT=f"00-{trace_id}-{parent}-01", **extra),
                out, os.path.join(tmp, f"trial-{run}.log"))
            try:
                rc = proc.wait(timeout=900)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            wall = time.perf_counter() - t0
            with open(os.path.join(tmp, f"trial-{run}.log")) as f:
                log = f.read()
            assert rc == 0, (run, rc, log[-4000:])
            with open(out) as f:
                counts = json.load(f)
            for n, v in counts["launches"].items():
                total[n] += v
            return parent, counts["per_step"], wall

        def training_steps():
            return [b for m, p, h, b in master.requests
                    if m == "POST" and p == "/api/v1/trials/1/metrics"
                    and b["group"] == "training"]

        try:
            # 1. the trial, preempted after step 8
            parent_a, per_step_a, wall_a = launch_trial(0)
            steps_a = [b["steps_completed"] for b in training_steps()]
            preempted = steps_a[-1]
            assert 8 <= preempted < CLUSTER_STEPS, steps_a
            assert "1.1.0" in master.acked, master.acked
            mono_only(per_step_a, preempted, "cluster trial")
            by_step = {b["metadata"]["steps_completed"]: u
                       for u, b in master.checkpoints.items()}
            assert preempted in by_step and 4 in by_step, by_step
            # 2. relaunched from the checkpoint it registered
            master.preempt_after_step = None
            parent_b, per_step_b, wall_b = launch_trial(
                1, DTPU_LATEST_CHECKPOINT=by_step[preempted])
            mono_only(per_step_b, CLUSTER_STEPS - preempted,
                      "cluster trial resumed")
            reports = training_steps()
            assert [b["steps_completed"] for b in reports] == list(
                range(1, CLUSTER_STEPS + 1)), [b["steps_completed"]
                                               for b in reports]
            assert master.completed[1]["length"] == CLUSTER_STEPS, \
                master.completed
            by_step = {b["metadata"]["steps_completed"]: u
                       for u, b in master.checkpoints.items()}
            assert CLUSTER_STEPS in by_step, by_step
            for u, b in master.checkpoints.items():
                assert b["state"] == "COMPLETED" and b["trial_id"] == 1, b
                assert verify_checkpoint_dir(os.path.join(store, u)), u
                assert "manifest.json" in b["resources"], b["resources"]
            # the replica starts (3. below) while the same trial runs
            # uninterrupted, off the cluster, in this process, without
            # checkpoints: its losses are the resumed run's reference
            out = os.path.join(tmp, "replica.json")
            log = os.path.join(tmp, "replica.log")
            t_replica = time.perf_counter()
            replica = self.counted_launch(
                "determined_tpu_torch.serving.service",
                ["--host", "127.0.0.1"], dict(
                    env, DTPU_ALLOCATION_ID="cmd.1.0", DTPU_TASK_ID="cmd-1",
                    DTPU_TASK_TYPE="SERVING",
                    DTPU_SERVING_CONFIG=json.dumps(SERVING_HTTP_CFG)),
                out, log)
            rc, per_step, launches, run, wall = self.harness_run(
                f"{builtin}:SyntheticTrial", hp, {
                    k: v for k, v in cfg.items()
                    if k != "min_checkpoint_period"},
                "chip-smoke-cluster-ref", os.path.join(tmp, "ckpt-ref"))
            assert rc == 0, rc
            mono_only(per_step, CLUSTER_STEPS, "uninterrupted")
            for n, v in launches.items():
                total[n] += v
            rel = max(abs(b["metrics"]["loss"] - run[b["steps_completed"]][
                "loss"]) / abs(run[b["steps_completed"]]["loss"])
                for b in reports)
            assert rel <= 1e-3, rel
            # the trial's spans, parented under DTPU_TRACEPARENT
            spans = [sp_ for sp_ in master.spans if sp_["traceId"] == trace_id]
            for parent in (parent_a, parent_b):
                runs = [sp_ for sp_ in spans if sp_["name"] == "trial.run"
                        and sp_.get("parentSpanId") == parent]
                assert len(runs) == 1, (parent, spans)
                fits = [sp_ for sp_ in spans if sp_["name"] == "trial.fit"
                        and sp_.get("parentSpanId") == runs[0]["spanId"]]
                assert len(fits) == 1, spans
                firsts = [sp_ for sp_ in spans
                          if sp_["name"] == "trial.first_step"
                          and sp_.get("parentSpanId") == fits[0]["spanId"]]
                assert len(firsts) == 1, spans
            phases = {smp.get("phase") for w in master.windows
                      if w["target"] == "trial:1.r0" for smp in w["samples"]}
            assert {"step", "checkpoint"} <= phases, phases
            done = [c for c in master.captures.values() if "artifact" in c]
            assert len(done) == 1 and not done[0]["error"], master.captures
            artifact = os.path.join(store, done[0]["artifact"])
            traces = [f for f in os.listdir(artifact)
                      if f.endswith(".pt.trace.json")]
            assert traces, os.listdir(artifact)
            assert any(ln.get("trace") == trace_id for ln in master.lines), \
                master.lines[:3]
            for m, p, h, b in master.requests:
                assert h.get("Authorization") == f"Bearer {token}", (m, p)
                if m == "POST":
                    assert h.get("X-Request-Id"), (m, p)

            def step_ms(bodies, skip):
                return float(np.median([1e3 / b["metrics"][
                    "batches_per_second"] for b in bodies
                    if b["steps_completed"] not in skip]))

            # warm-up steps, the traced step, the windows of async saves
            skip = {1, 2, 5, 9, preempted + 1, preempted + 2}
            cluster_ms = step_ms(reports, skip)
            rec.update(
                trial_rc=0, preempted_at=preempted, resumed_rc=0,
                steps=CLUSTER_STEPS, wall_s=wall_a, resumed_wall_s=wall_b,
                loss_first=reports[0]["metrics"]["loss"],
                loss_last=reports[-1]["metrics"]["loss"],
                loss_max_rel=rel, checkpoints=len(master.checkpoints),
                spans=len(master.spans), profile_windows=len(master.windows),
                log_lines=len(master.lines), requests=len(master.requests),
                capture_files=len(traces),
                cluster_step_ms_median=cluster_ms,
                exec_step_ms_median=self.exec_step_ms,
                cluster_minus_exec_ms=cluster_ms - self.exec_step_ms,
                cluster_over_exec_pct=100.0 * (cluster_ms / self.exec_step_ms
                                               - 1.0))

            # 3. the serving replica
            proc = replica
            try:
                master.wait_for(lambda: "cmd.1.0" in master.proxies
                                or proc.poll() is not None, 600,
                                "the replica's proxy registration")
                replica_up_s = time.perf_counter() - t_replica
                assert proc.poll() is None, open(log).read()[-4000:]
                url = f"http://127.0.0.1:{master.proxies['cmd.1.0'][1]}"
                warm = loadgen.drive(url, 4, 4, prompt_len=8,
                                     max_new_tokens=2, timeout_s=600.0)
                assert warm.completed == 4, [t.error for t in warm.traces]
                prompts = loadgen.zipf_prefix_prompts(**SERVING_HTTP_PROMPTS)
                issued, lock = [], threading.Lock()
                request = http.client.HTTPConnection.request

                def traced(conn, method, target, body=None, headers=None,
                           **kw):
                    headers = dict(headers or {})
                    if target.endswith("/api/v1/generate"):
                        ctx = (secrets.token_hex(16), secrets.token_hex(8))
                        with lock:
                            issued.append(ctx)
                        headers["traceparent"] = f"00-{ctx[0]}-{ctx[1]}-01"
                    return request(conn, method, target, body=body,
                                   headers=headers, **kw)

                http.client.HTTPConnection.request = traced
                try:
                    report = loadgen.drive(url, len(prompts),
                                           SERVING_HTTP_CONC,
                                           max_new_tokens=SERVING_HTTP_NEW_TOKENS,
                                           timeout_s=600.0, prompts=prompts)
                finally:
                    http.client.HTTPConnection.request = request
                assert report.completed == len(prompts), [
                    t.error for t in report.traces]
                assert all(len(t.token_ids) == SERVING_HTTP_NEW_TOKENS
                           for t in report.traces)
                assert len(issued) == len(prompts), len(issued)

                def request_spans():
                    out_ = {}
                    for sp_ in master.spans:
                        out_.setdefault(sp_["traceId"], []).append(sp_)
                    return out_

                master.wait_for(lambda: all(
                    any(sp_["name"] == "serving.decode" for sp_ in
                        request_spans().get(t, [])) for t, _ in issued),
                    60, "the replica's request spans")
                by_trace = request_spans()
                for t, parent in issued:
                    roots = [sp_ for sp_ in by_trace[t]
                             if sp_["name"] == "serving.request"]
                    assert len(roots) == 1 and roots[0].get(
                        "parentSpanId") == parent, by_trace[t]
                    kids = {sp_["name"] for sp_ in by_trace[t]
                            if sp_.get("parentSpanId") == roots[0]["spanId"]}
                    assert kids == {"serving.queue", "serving.prefill",
                                    "serving.decode"}, kids
                master.preempt("cmd.1.0")
                rc = proc.wait(timeout=120)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            assert rc == 0, (rc, open(log).read()[-4000:])
            with open(out) as f:
                counts = json.load(f)["launches"]
            assert counts["flash_fwd"] > 0 and counts["paged_attention"] > 0, \
                counts
            for n, v in counts.items():
                total[n] += v
            rec.update(
                replica_rc=rc, replica_requests=len(prompts),
                replica_tokens=report.total_tokens,
                replica_tokens_per_s=report.tokens_per_sec,
                serving_http_tokens_per_s=self.serving_http_tps,
                replica_ttft_p50_ms=report.ttft_percentile_ms(50),
                replica_flash_launches=counts["flash_fwd"],
                replica_paged_launches=counts["paged_attention"],
                replica_up_s=replica_up_s)
        finally:
            if replica is not None and replica.poll() is None:
                replica.kill()
                replica.wait()
            master.stop()
            shutil.rmtree(tmp, ignore_errors=True)
            shutil.rmtree(os.path.join(tempfile.gettempdir(),
                                       "dtpu-tb-chip-smoke-cluster-ref"),
                          ignore_errors=True)
        rec.update({f"{n}_launches": v for n, v in total.items() if v})
        rec["phase_s"] = time.perf_counter() - t_phase
        self.report("cluster", "trial and replica as tasks of a stand-in "
                    "master: gpt2-small B8x1024 preempted and resumed, "
                    "GPT-2-small bf16 replica", rec)
        return total

    # -- phase 18: training on a data x fsdp mesh ---------------------------------
    def mesh_phase(self):
        """One rank over NCCL at full width (the headline trial and the
        packed batch on a data=1 x fsdp=1 mesh, a sharded save and its
        resume, the audit), then two ranks on the one card at fsdp=2 over
        gloo in subprocesses."""
        import datetime
        import socket
        import tempfile

        import numpy as np
        import torch
        import torch.distributed as dist

        from determined_tpu_torch import core
        from determined_tpu_torch.common import faults
        from determined_tpu_torch.core._distributed import DistributedContext
        from determined_tpu_torch.models import gpt
        from determined_tpu_torch.parallel import MeshConfig, make_mesh
        from determined_tpu_torch.trainer import Batch, Trainer
        from determined_tpu_torch.trainer import _checkpoint as ckpt_io
        from determined_tpu_torch.trainer.profile import RepeatedBatchTrial

        def free_port():
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                return s.getsockname()[1]

        def close(losses, want, what):
            rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
            assert len(losses) == len(want) and max(rel) < 1e-3, (
                what, losses, want)
            return max(rel)

        t0 = time.perf_counter()
        b, s = 8, 1024
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=300),
            device_id=torch.device("cuda", 0))
        launches = {}
        try:
            dctx = DistributedContext(rank=0, size=1)
            mesh = make_mesh(MeshConfig(data=1, fsdp=1))
            assert dist.get_backend(mesh.get_group("fsdp")) == "nccl"
            tmp = tempfile.mkdtemp(prefix="dtpu-mesh-")
            saved, audits = {}, []

            def prepare(trainer):
                save, audit = trainer._save_checkpoint, \
                    trainer._divergence_audit

                def recording_save(**kw):
                    if trainer._step == MESH_SAVE_AT:
                        saved["state"] = [
                            leaf.detach().cpu().clone() for _, leaf in
                            ckpt_io._flatten_with_path(
                                trainer._state_view())
                            if isinstance(leaf, torch.Tensor)] + [
                            leaf.local.detach().cpu().clone() for _, leaf in
                            ckpt_io._flatten_with_path(
                                trainer._state_view())
                            if isinstance(leaf, ckpt_io.Shard)]
                    return save(**kw)

                def counted_audit():
                    audits.append(trainer.steps_completed)
                    audit()

                trainer._save_checkpoint = recording_save
                trainer._divergence_audit = counted_audit
                saved["trainer"] = trainer

            ctx = core._dummy_init(distributed=dctx, checkpoint_storage=tmp)
            reports, per_step, run, peak_gb, cfg = self.fit_counted(
                RepeatedBatchTrial(b, s), MESH_STEPS, ctx=ctx,
                prepare=prepare, checkpoint_period=Batch(MESH_SAVE_AT),
                trainer_kw=dict(mesh=mesh,
                                health={"divergence_check_period": 2}))
            launches = dict(run)
            losses = [m["loss"] for m in reports]
            err = close(losses, self.train_losses, "one rank vs phase train")
            for i, step in enumerate(per_step):
                assert step["flash_fwd_mono"] == cfg.n_layers, (i, step)
                assert step["flash_bwd_mono"] == cfg.n_layers, (i, step)
                assert step["flash_fwd"] == 0, (i, step)
            assert audits == [2, 4, 6], audits
            rec = self.train_record(reports, run, peak_gb, cfg, b, s, warm=2)
            # the trained state's resident bytes: the model's parameters,
            # the trainer's parameter tensors that are not theirs (none:
            # the model holds the blocks) and the AdamW moments
            one = saved.pop("trainer")
            working = list(one.model.parameters())
            split = [t for t in one._params
                     if all(t.data_ptr() != w.data_ptr() for w in working)]
            split += [t for s in one._opt_state[1][0][1:] for t in s]
            gb = lambda ts: sum(t.numel() * t.element_size() for t in ts) / 1e9
            state_gb, split_gb = gb(working) + gb(split), gb(split)
            self.mesh_state_gb = state_gb  # phase tensor's yardstick
            del one, working, split
            # the sharded save at step 4, resumed by a fresh trainer
            ids = {}
            for uuid_ in os.listdir(tmp):
                with open(os.path.join(tmp, uuid_, "metadata.json")) as f:
                    ids[json.load(f)["steps_completed"]] = uuid_
            resumed = Trainer(RepeatedBatchTrial(b, s), core._dummy_init(
                distributed=dctx, checkpoint_storage=tmp), mesh=mesh)
            resumed._restore_with_fallback(ids[MESH_SAVE_AT])
            view = resumed._state_view()
            got = [leaf.detach().cpu() for _, leaf in
                   ckpt_io._flatten_with_path(view)
                   if isinstance(leaf, torch.Tensor)] + [
                leaf.local.detach().cpu() for _, leaf in
                ckpt_io._flatten_with_path(view)
                if isinstance(leaf, ckpt_io.Shard)]
            assert len(got) == len(saved["state"]) and all(
                torch.equal(a, w) for a, w in zip(got, saved["state"]))
            # one rank holds one copy of every block: the drill's perturbed
            # checksum has nothing to disagree with (as the reference on
            # one device); two ranks below
            os.environ["DTPU_FAULT_PLAN"] = json.dumps(
                {"train.divergence.rank0": {"failures": 1}})
            faults.clear()
            try:
                resumed._divergence_audit()
            finally:
                del os.environ["DTPU_FAULT_PLAN"]
                faults.clear()
            # the collectives of one step and their bytes, counted where
            # the step calls them
            calls, nbytes, real = {}, {}, {}
            for name in ("all_reduce", "all_gather_into_tensor",
                         "reduce_scatter_tensor", "broadcast"):
                real[name] = getattr(dist, name)

                def counting(*args, _name=name, **kw):
                    t = args[1] if _name == "reduce_scatter_tensor" else args[0]
                    calls[_name] = calls.get(_name, 0) + 1
                    nbytes[_name] = nbytes.get(_name, 0) + (
                        t.numel() * t.element_size())
                    return real[_name](*args, **kw)

                setattr(dist, name, counting)
            try:
                resumed._train_step(resumed._put_batch(next(
                    RepeatedBatchTrial(b, s).build_training_data())))
                torch.cuda.synchronize()
            finally:
                for name, fn in real.items():
                    setattr(dist, name, fn)
            del resumed, view, got, saved["state"]
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
            torch.cuda.empty_cache()
            # the packed batch through flash_fwd and flash_bwd_blocked
            trial = RepeatedBatchTrial(b, s, config=gpt.small())
            batch = packed_batch(b, s, 3, trial.config.vocab_size)

            def repeated():
                while True:
                    yield batch

            trial.build_training_data = repeated
            trial.replicated_batch_keys = frozenset()
            preports, pper_step, prun, _, _ = self.fit_counted(
                trial, PACKED_STEPS, ctx=core._dummy_init(distributed=dctx),
                trainer_kw=dict(mesh=mesh))
            perr = close([m["loss"] for m in preports], self.packed_losses,
                         "packed vs phase train-packed")
            want = dict(flash_fwd=cfg.n_layers, flash_bwd_blocked=cfg.n_layers)
            for i, step in enumerate(pper_step):
                got = {n: v for n, v in step.items() if v}
                assert got == want, (i, step)
            for n, v in prun.items():
                launches[n] = launches.get(n, 0) + v
            dctx.close()
        finally:
            dist.destroy_process_group()
        one_s = time.perf_counter() - t0

        # two ranks on the one card, fsdp=2 over gloo
        t1 = time.perf_counter()
        port = free_port()
        outs = [tempfile.mktemp(prefix=f"dtpu-mesh-rank{r}-", suffix=".json")
                for r in range(2)]
        logs = [tempfile.TemporaryFile() for _ in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", MESH_RANK, str(r), str(port), outs[r],
             str(MESH_GANG_STEPS)], stdout=logs[r], stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
            for r in range(2)]
        try:
            codes = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, code in enumerate(codes):
            logs[r].seek(0)
            assert code == 0, (r, logs[r].read().decode()[-4000:])
            logs[r].close()
        ranks = []
        for out in outs:
            with open(out) as f:
                ranks.append(json.load(f))
            os.remove(out)
        two_s = time.perf_counter() - t1
        for r in ranks:
            assert r["losses"] == ranks[0]["losses"], ranks
            assert r["audits"] == list(range(1, MESH_GANG_STEPS + 1)), r
            for i, step in enumerate(r["per_step"]):
                assert step["flash_fwd_mono"] == cfg.n_layers, (i, step)
                assert step["flash_bwd_mono"] == cfg.n_layers, (i, step)
                for n, v in step.items():
                    launches[n] = launches.get(n, 0) + v
            # two holders of each whole block: no majority, both named
            assert "suspect rank 0 device cuda:0" in r["drill"], r["drill"]
        gang_err = close(ranks[0]["losses"], losses[:MESH_GANG_STEPS],
                         "two ranks vs one rank")
        norms = [m["grad_norm"] for m in reports][:MESH_GANG_STEPS]
        gang_norm_err = max(abs(a - b) / abs(b) for a, b in zip(
            ranks[0]["grad_norms"], norms))
        assert gang_norm_err < GRAD_NORM_RTOL, (ranks[0]["grad_norms"], norms)
        for r in ranks:
            assert r["grad_norms"] == ranks[0]["grad_norms"], ranks
            # ZeRO-3: between steps a rank holds its blocks (12 bytes a
            # parameter: master, mu, nu), not a whole fp32 copy
            assert r["state_gb"] < 0.6 * state_gb, (r["state_gb"], state_gb)
        self.report("mesh", "gpt2-small bf16 B8x1024 data x fsdp", dict(
            one_rank_backend="nccl", steps=len(reports),
            loss_first=losses[0], loss_last=losses[-1],
            max_rel_loss_vs_train=err,
            step_ms_median=rec["step_ms_median"],
            train_phase_step_ms_median=self.train_step_ms,
            mesh_minus_train_ms=rec["step_ms_median"] - self.train_step_ms,
            peak_gb=peak_gb, train_phase_peak_gb=self.train_peak_gb,
            state_gb=state_gb, split_gb=split_gb, audits=len(audits),
            resume_bitwise=True,
            collectives_per_step=calls,
            collective_mb_per_step={k: round(v / 1e6, 3)
                                    for k, v in nbytes.items()},
            packed_max_rel_loss_vs_train_packed=perr,
            one_rank_seconds=one_s,
            gang_backend="gloo", gang_ranks=2, gang_fsdp=2,
            gang_step_ms=[float(np.median(r["step_ms"][1:])) for r in ranks],
            gang_peak_gb=[r["peak_gb"] for r in ranks],
            gang_state_gb=[r["state_gb"] for r in ranks],
            gang_split_gb=[r["split_gb"] for r in ranks],
            gang_collectives_per_step=ranks[0]["collectives_per_step"],
            gang_collective_mb_per_step=ranks[0]["collective_mb_per_step"],
            gang_max_rel_loss_vs_one_rank=gang_err,
            gang_max_rel_grad_norm_vs_one_rank=gang_norm_err,
            gang_launches_per_step_and_rank=ranks[0]["per_step"][-1],
            gang_drill=ranks[0]["drill"][:120],
            gang_seconds=two_s,
            seconds=time.perf_counter() - t0,
        ))
        return launches

    def context_phase(self):
        """Training over the context axis: two ranks on the one card over
        gloo (``CONTEXT_RANK``) at ``MeshConfig(data=1, context=2)``, each
        run of ``CONTEXT_RUNS`` held against the one-device run of the same
        trial (phases train, train-long and train-32k; the 64k rung and the
        packed window run here, before the ranks start): every loss within
        1e-3 relative (bf16; dq by fp32 atomics); per step and rank, the
        hops' flash launches and nothing else. → launches."""
        import dataclasses
        import json
        import socket
        import tempfile

        import numpy as np
        import torch

        from determined_tpu_torch.data import write_token_shard
        from determined_tpu_torch.trainer.profile import (
            RUNGS,
            RepeatedBatchTrial,
            packed_batch,
        )

        def close(losses, want, what):
            rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
            assert len(losses) <= len(want) and max(rel) < 1e-3, (
                what, losses, want)
            return max(rel)

        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix="dtpu-context-")
        # the one-device yardsticks this phase makes itself
        refs = {"headline-ring": self.train_losses,
                "headline-ulysses": self.train_losses,
                "long16k-ring": self.long_losses,
                "long16k-zigzag": self.long_losses,
                "long32k-ring": self.long32_losses}
        launches = {}
        for name in ("packed-window-ring", "long64k-ring"):
            rung, b, seq, steps, data, fields, *_ = CONTEXT_RUNS[name]
            cfg = dataclasses.replace(RUNGS[rung][1], **fields)
            trial = RepeatedBatchTrial(b, seq, config=cfg)
            if data == "packed":
                batch = packed_batch(b, seq, 3, cfg.vocab_size)

                def repeated(batch=batch):
                    while True:
                        yield batch

                trial.build_training_data = repeated
            reports, _, one, peak_gb, cfg = self.fit_counted(trial, steps)
            refs[name] = [m["loss"] for m in reports]
            if name == "packed-window-ring":  # phase tensor's yardstick too
                self.packed_window_losses = refs[name]
                self.packed_window_grad_norms = [m["grad_norm"]
                                                 for m in reports]
            self.report("context", f"gpt2-small bf16 {name} one device",
                        self.train_record(reports, one, peak_gb, cfg, b, seq,
                                          warm=1))
            for n, v in one.items():
                launches[n] = launches.get(n, 0) + v
        # the zigzag loader's shard: the long16k rung's tokens and one more
        # that the loader reads (its target is masked), and one it does
        # not (the loader wants a token past its S + 1 window: each row
        # starts at 0, below max(total - (S + 1), 1))
        b16, cfg16 = RUNGS["long16k"]
        tokens = next(RepeatedBatchTrial(b16, cfg16.seq_len, config=cfg16)
                      .build_training_data())["tokens"]
        shard = os.path.join(tmp, "long16k.bin")
        write_token_shard(shard, np.concatenate([tokens[0], [0, 0]]))
        runs = [dict(name=name, rung=r[0], batch=r[1], seq=r[2], steps=r[3],
                     data=r[4], fields=r[5], shard=shard)
                for name, r in CONTEXT_RUNS.items()]
        spec = os.path.join(tmp, "runs.json")
        with open(spec, "w") as f:
            json.dump(runs, f)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        logs = [tempfile.TemporaryFile() for _ in range(2)]
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", CONTEXT_RANK, str(r), str(port), outs[r],
             spec], stdout=logs[r], stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
            for r in range(2)]
        try:
            codes = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, code in enumerate(codes):
            logs[r].seek(0)
            assert code == 0, (r, logs[r].read().decode()[-4000:])
            logs[r].close()
        ranks = []
        for out in outs:
            with open(out) as f:
                ranks.append({x["name"]: x for x in json.load(f)})
        gang_s = time.perf_counter() - t1
        n = 12  # GPT-2-small's layers
        for name, (rung, b, seq, steps, data, fields, layout, kernels,
                   fwd_per_call) in CONTEXT_RUNS.items():
            rec = dict(backend="gloo", context=2, steps=steps, batch=b,
                       seq=seq, s_local=seq // 2)
            for r in range(2):
                x = ranks[r][name]
                assert x["losses"] == ranks[0][name]["losses"], (name, x)
                # the flash calls a layer on this rank: the hops it attends
                if layout == "zigzag":
                    calls = 4   # diag (3 half-chunk calls) + one more hop
                elif layout == "none":
                    calls = 0   # Ulysses: dense local attention
                else:           # contiguous / window: the hops before it
                    calls = r + 1
                want = {}
                if kernels:
                    want[kernels[0]] = n * calls * fwd_per_call
                    for kname in kernels[1:]:
                        want[kname] = n * calls
                for i, step in enumerate(x["per_step"]):
                    got = {k: v for k, v in step.items() if v}
                    assert got == want, (name, r, i, step, want)
                    for k, v in step.items():
                        launches[k] = launches.get(k, 0) + v
                rec[f"rank{r}_step_ms_median"] = float(
                    np.median(x["step_ms"][1:]))
                rec[f"rank{r}_peak_gb"] = x["peak_gb"]
                rec[f"rank{r}_launches_per_step"] = want
                rec[f"rank{r}_hop_calls_per_step"] = x["hop_calls_per_step"]
            x = ranks[0][name]
            rec.update(
                loss_first=x["losses"][0], loss_last=x["losses"][-1],
                max_rel_loss_vs_one_device=close(x["losses"], refs[name],
                                                 f"{name} vs one device"),
                transport=(x["transport"] if layout != "none"
                           else "gloo all_to_all_single"),
                rotations_per_step=x["shifts_per_step"],
                rotated_mb_per_step=x["rotated_mb_per_step"],
                collectives_per_step=x["collectives_per_step"],
                collective_mb_per_step=x["collective_mb_per_step"])
            self.report("context", f"gpt2-small bf16 {name}", rec)
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
        self.report("context", "phase", dict(gang_seconds=gang_s,
                                             seconds=time.perf_counter() - t0))
        return launches

    def gang_runs(self, tmp, tag, params, runs):
        """Gangs on the one card over gloo (``TENSOR_RANK``), one a world
        size, each rank training the runs of its world (dicts with
        ``world``, ``name``, ``mesh``, ``data``, ``fields``, ``steps``,
        ``save_at``, optionally ``params``: whole weights, else `params`);
        a run's sharded save goes to ``<tmp>/ckpt<world>``. The ranks
        share the card with this process, which frees its cached blocks
        first, and allocate through expandable segments (four ranks of an
        expert model at ``context=2`` peak at ~17.7 GB each). A gang that
        fails shows the log of every rank that failed, the ones that saw
        a peer's connection close last. → ({run: every rank's result},
        {world: seconds})."""
        import gc
        import json
        import socket
        import tempfile

        import torch

        env = dict(os.environ,
                   PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
        results, seconds = {}, {}
        for world in sorted({r["world"] for r in runs}):
            gc.collect()
            torch.cuda.empty_cache()
            free, total = torch.cuda.mem_get_info()
            print(f"  gang {tag} world={world}: {free / 1e9:.2f} of "
                  f"{total / 1e9:.2f} GB free on the card, this process "
                  f"holding {torch.cuda.memory_allocated() / 1e9:.2f}",
                  flush=True)
            spec = os.path.join(tmp, f"{tag}-runs{world}.json")
            with open(spec, "w") as f:
                json.dump(dict(params=params,
                               runs=[r for r in runs if r["world"] == world],
                               ckpt=os.path.join(tmp, f"ckpt{world}")), f)
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            outs = [os.path.join(tmp, f"{tag}-w{world}-rank{r}.json")
                    for r in range(world)]
            logs = [tempfile.TemporaryFile() for _ in range(world)]
            t1 = time.perf_counter()
            procs = [subprocess.Popen(
                [sys.executable, "-c", TENSOR_RANK, str(r), str(world),
                 str(port), outs[r], spec], stdout=logs[r],
                stderr=subprocess.STDOUT, env=env,
                cwd=os.path.dirname(os.path.abspath(__file__)))
                for r in range(world)]
            try:
                codes = [p.wait(timeout=600) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            tails = {}
            for r, code in enumerate(codes):
                logs[r].seek(0)
                if code != 0:
                    tails[r] = logs[r].read().decode()[-3000:]
                logs[r].close()
            assert not tails, (tag, world, sorted(
                tails.items(), key=lambda kv: "closed by peer" in kv[1]))
            for out in outs:
                with open(out) as f:
                    for x in json.load(f):
                        results.setdefault(x["name"], []).append(x)
            seconds[world] = time.perf_counter() - t1
        return results, seconds

    def tensor_phase(self):
        """Training over the tensor axis: gangs on the one card over gloo
        (``TENSOR_RANK``), each run of ``TENSOR_RUNS`` held against the
        one-device run of the same trial (phase train; the packed window
        run of phase context): every loss within 1e-3 relative, every rank
        alike; per step and rank, the flash launches of its H/tensor = 6
        heads and nothing else; the resident state of a rank below one
        device's (phase mesh's one rank); the tensor=2 run's sharded save
        in the reference's names, restored bit for bit by a fresh trainer
        that goes on with the uninterrupted run's losses, the audit every
        step finding nothing. First the deterministic pair
        (``TWO_PASS_RUNS``): the one-device two-pass run twice, its losses
        and grad norms bit for bit the same, then held against by the
        tensor=2 two-pass run on every step. → launches."""
        import tempfile

        import numpy as np
        import torch

        from determined_tpu_torch.ops import flash_attention as tfa
        from determined_tpu_torch.trainer.profile import (RUNGS,
                                                          RepeatedBatchTrial)

        def close(losses, want, what, rtol=1e-3):
            rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
            assert 0 < len(losses) <= len(want) and max(rel) < rtol, (
                what, losses, want)
            return max(rel)

        t0 = time.perf_counter()
        n = 12  # GPT-2-small's layers
        # the deterministic pair's one-device half, twice
        cfg = dataclasses.replace(RUNGS["headline"][1], **TWO_PASS_FIELDS)
        cap, pair, launches = tfa._FUSED_BWD_PARTIALS_CAP, [], {}
        for _ in range(2):
            tfa._FUSED_BWD_PARTIALS_CAP = 0
            try:
                reports, per_step, run, peak_gb, _ = self.fit_counted(
                    RepeatedBatchTrial(8, 1024, config=cfg), TWO_PASS_STEPS)
            finally:
                tfa._FUSED_BWD_PARTIALS_CAP = cap
            for i, step in enumerate(per_step):
                got = {k: v for k, v in step.items() if v}
                assert got == {"flash_fwd": n, "flash_bwd_dq": n,
                               "flash_bwd_dkv": n}, (i, step)
            for k, v in run.items():
                launches[k] = launches.get(k, 0) + v
            pair.append(dict(
                losses=[m["loss"] for m in reports],
                grad_norms=[m["grad_norm"] for m in reports],
                rec=self.train_record(reports, run, peak_gb, cfg, 8, 1024,
                                      warm=1)))
        repeats = (pair[0]["grad_norms"] == pair[1]["grad_norms"]
                   and pair[0]["losses"] == pair[1]["losses"])
        self.report("tensor", "gpt2-small bf16 one device two-pass", dict(
            pair[0]["rec"], losses=pair[0]["losses"],
            grad_norms=pair[0]["grad_norms"],
            again_losses=pair[1]["losses"],
            again_grad_norms=pair[1]["grad_norms"],
            repeats_bit_for_bit=repeats))
        assert repeats, ("the two-pass one-device run does not repeat",
                         pair)
        tmp = tempfile.mkdtemp(prefix="dtpu-tensor-")
        # the headline trial's seeded weights, whole, for load_jax_params
        model = RepeatedBatchTrial(8, 1024).build_model(self.dev)
        params = os.path.join(tmp, "params.npz")
        np.savez(params, **{n: p.detach().cpu().numpy()
                            for n, p in model.named_parameters()})
        del model
        torch.cuda.empty_cache()
        refs = {"headline-t2": self.train_losses,
                "packed-window-t2": self.packed_window_losses,
                "headline-c2t2-ring": self.train_losses,
                "headline-c2t2-ulysses": self.train_losses,
                "headline-t2-two-pass": pair[0]["losses"]}
        # the grad norms too: AdamW all but hides a gradient's scale from
        # the losses, and a replicated leaf's gradient summed over the
        # tensor group comes out tensor times too large
        norm_refs = {"headline-t2": self.train_grad_norms,
                     "packed-window-t2": self.packed_window_grad_norms,
                     "headline-c2t2-ring": self.train_grad_norms,
                     "headline-c2t2-ulysses": self.train_grad_norms,
                     "headline-t2-two-pass": pair[0]["grad_norms"]}
        results, seconds = self.gang_runs(tmp, "tensor", params, [
            dict(name=name, world=r[0], mesh=r[1], data=r[2], fields=r[3],
                 steps=r[4], save_at=r[5], two_pass=name in TWO_PASS_RUNS)
            for name, r in TENSOR_RUNS.items()])
        for name, (world, sizes, data, fields, steps, save_at, kernels,
                   calls) in TENSOR_RUNS.items():
            ranks = results[name]
            assert len(ranks) == world, (name, len(ranks))
            rec = dict(backend="gloo", ranks=world, **sizes, steps=steps,
                       batch=8, seq=1024, heads_per_rank=6)
            for x in ranks:
                r = x["rank"]
                assert x["losses"] == ranks[0]["losses"], (name, x)
                assert x["grad_norms"] == ranks[0]["grad_norms"], (name, x)
                assert x["wqkv_shape"] == [12, 768, 3, 6, 64], x
                context_index = x["coordinate"][4]
                per_layer = {"one": 1, "ring": context_index + 1,
                             "none": 0}[calls]
                want = {k: n * per_layer for k in kernels} if per_layer else {}
                for i, step in enumerate(x["per_step"]):
                    got = {k: v for k, v in step.items() if v}
                    assert got == want, (name, r, i, step, want)
                    for k, v in step.items():
                        launches[k] = launches.get(k, 0) + v
                assert x["state_gb"] < self.mesh_state_gb, (
                    name, r, x["state_gb"], self.mesh_state_gb)
                rec[f"rank{r}_step_ms_median"] = float(
                    np.median(x["step_ms"][1:]))
                rec[f"rank{r}_peak_gb"] = x["peak_gb"]
                rec[f"rank{r}_state_gb"] = x["state_gb"]
                rec[f"rank{r}_launches_per_step"] = want
                if save_at:
                    assert x["audits"] == list(range(1, steps + 1)), x
                    assert x["resume_bitwise"], (name, r)
                    close(x["resumed_losses"], x["losses"][save_at:],
                          f"{name} rank {r} resumed")
                    assert x["resumed_losses"] == (
                        x["losses"][save_at:]), (name, r)
            x = ranks[0]
            held = TENSOR_NORM_STEPS.get(name, steps)
            rec.update(
                loss_first=x["losses"][0], loss_last=x["losses"][-1],
                max_rel_loss_vs_one_device=close(
                    x["losses"], refs[name], f"{name} vs one device"),
                # every step's reading, the held ones asserted
                rel_grad_norm_by_step=[
                    abs(a - b) / abs(b) for a, b in zip(x["grad_norms"],
                                                        norm_refs[name])],
                grad_norm_steps_held=held,
                max_rel_grad_norm_vs_one_device=close(
                    x["grad_norms"][:held], norm_refs[name],
                    f"{name} grad norm vs one device", GRAD_NORM_RTOL),
                one_device_state_gb=self.mesh_state_gb,
                rotations_per_step=x["rotations_per_step"],
                collectives_per_step=x["collectives_per_step"],
                collective_mb_per_step=x["collective_mb_per_step"])
            if save_at:
                files = x["files"]
                assert files.count("manifest.json") == 1, files
                for f in ("params__blocks__wqkv.shard0_0_0_0_0.npy",
                          "params__blocks__wqkv.shard0_0_0_6_0.npy",
                          "params__tok_embed.shard0_0.npy",
                          "params__tok_embed.shard25152_0.npy",
                          "params__blocks__wi.shard0_0_1536.npy",
                          "params__pos_embed.npy", "params__blocks__bo.npy"):
                    assert f in files, (f, files)
                rec.update(ckpt_files=len(files), resume_bitwise=True,
                           resumed_loss=x["resumed_losses"][0],
                           audits=len(x["audits"]))
            self.report("tensor", f"gpt2-small bf16 {name}", rec)
        # the sharded saves phase elastic restores onto other layouts (it
        # removes them): run → (its checkpoint directory, the save's step)
        self.tensor_saves = {
            name: (os.path.join(tmp, f"ckpt{r[0]}"), r[5])
            for name, r in TENSOR_RUNS.items() if r[5]}
        self.tensor_tmp = tmp
        self.report("tensor", "phase", dict(
            **{f"gang{w}_seconds": v for w, v in seconds.items()},
            seconds=time.perf_counter() - t0))
        return launches

    def elastic_phase(self):
        """The elastic resize end to end, against ``StandInMaster``: a gang
        of two ranks on the one card over gloo, each launched as the
        platform launches a task (``python -m
        determined_tpu_torch.exec.prep_and_run``: the rendezvous, then the
        harness), trains GPT-2-small at B 8 x 1024 on ``fsdp=2`` and saves
        at step 2; rank 1 is SIGKILLed right after that save registers
        and the stand-in resizes the gang (generation 1, rank_map {"0":
        0}). The survivor's failed collective asks the master, leaves
        ``fit`` by ``ElasticResizeExit``, re-enters the rendezvous, refits
        the mesh to one rank over NCCL, restores step 2 onto it and trains
        to step 6, exit 0 within ``ELASTIC_EXIT_S`` of the kill (past it,
        its stacks and log fail the phase): its losses from step 3 on
        within 1e-3 of one device restored from the same checkpoint, the
        ledger's resize and no restart. Then restore only, one step after
        each, against the one-device continuation within 1e-3: phase
        tensor's ``tensor=2`` save onto one rank over NCCL, and its
        ``context=2 x tensor=2`` save onto ``fsdp=2`` (``ELASTIC_RANK``).
        → launches."""
        import datetime
        import secrets
        import shutil
        import socket
        import tempfile

        import numpy as np
        import torch
        import torch.distributed as dist

        from determined_tpu_torch import core
        from determined_tpu_torch.exec.builtin_trials import SyntheticTrial
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.parallel import MeshConfig, make_mesh
        from determined_tpu_torch.trainer import Batch, Trainer
        from determined_tpu_torch.trainer.profile import (
            RUNGS,
            RepeatedBatchTrial,
        )

        def close(got, want, what):
            rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
            assert len(got) == len(want) > 0 and max(rel) < 1e-3, (
                what, got, want)
            return max(rel)

        def free_port():
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                return sock.getsockname()[1]

        def by_step(directory):
            ids = {}
            for uuid_ in os.listdir(directory):
                path = os.path.join(directory, uuid_, "metadata.json")
                if os.path.exists(path):
                    with open(path) as f:
                        ids[json.load(f)["steps_completed"]] = uuid_
            return ids

        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix="dtpu-elastic-")
        store = os.path.join(tmp, "ckpt")
        master = StandInMaster(op_length=ELASTIC_STEPS)
        master.rendezvous_size = 2
        alloc = "1.7.0"
        hp = {"model": "gpt2-small", "batch_size": 8, "seq_len": 1024,
              "lr": 3e-4}
        cfg = {"searcher": {"name": "single", "metric": "loss",
                            "max_length": {"batches": ELASTIC_STEPS}},
               "min_checkpoint_period": {"batches": ELASTIC_SAVE_AT},
               "scheduling_unit": 1, "tensorboard": False}
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DTPU_")}
        env.update(
            TMPDIR=tmp, DTPU_MASTER=master.url,
            DTPU_SESSION_TOKEN=secrets.token_hex(16),
            DTPU_CLUSTER_ID="chip-smoke", DTPU_TASK_ID="trial-7",
            DTPU_TASK_TYPE="TRIAL", DTPU_TRIAL_ID="7",
            DTPU_EXPERIMENT_ID="1", DTPU_TRIAL_SEED="0",
            DTPU_HPARAMS=json.dumps(dict(hp, mesh={"data": 1, "fsdp": 2})),
            DTPU_EXPERIMENT_CONFIG=json.dumps(cfg),
            DTPU_CHECKPOINT_STORAGE=json.dumps(
                {"type": "shared_fs", "host_path": store}),
            DTPU_ENTRYPOINT="determined_tpu_torch.exec.builtin_trials:"
                           "SyntheticTrial",
            DTPU_ALLOCATION_ID=alloc, DTPU_ALLOC_NUM_PROCS="2")
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(2)]
        procs = [self.counted_launch(
            "determined_tpu_torch.exec.prep_and_run", [],
            dict(env, DTPU_ALLOC_RANK=str(r)), outs[r], logs[r])
            for r in range(2)]
        try:
            def saved():
                return [b for b in master.checkpoints.values()
                        if b["state"] == "COMPLETED"
                        and b["metadata"]["steps_completed"]
                        == ELASTIC_SAVE_AT]

            try:
                master.wait_for(lambda: saved() or procs[0].poll()
                                is not None, 600, "the step-2 checkpoint")
            finally:
                if procs[0].poll() is not None:
                    with open(logs[0]) as f:
                        raise AssertionError(f.read()[-4000:])
            t_kill = time.perf_counter()
            procs[1].kill()
            directive = master.resize(alloc, [1], "rank 1 SIGKILLed")
            rc = self.wait_or_dump(procs[0], ELASTIC_EXIT_S, logs[0],
                                   "the resized survivor")
            t_exit = time.perf_counter()
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        with open(logs[0]) as f:
            log = f.read()
        assert rc == 0, (rc, log[-4000:])
        assert directive == {"generation": 1, "from_generation": 0,
                             "num_processes": 1, "rank_map": {"0": 0},
                             "reason": "rank 1 SIGKILLed"}, directive
        assert "elastic resize" in log and "entering fit (resize)" in log, (
            log[-4000:])
        with open(outs[0]) as f:
            counts = json.load(f)
        bodies = [(p, b) for m, p, h, b in master.requests if m == "POST"]
        reports = {}
        for p, b in bodies:
            if p == "/api/v1/trials/7/metrics" and b["group"] == "training":
                reports[b["steps_completed"]] = b["metrics"]
        ledger = [b["metrics"] for p, b in bodies
                  if p == "/api/v1/trials/7/metrics"
                  and b["group"] == "profiling"][-1]
        beats = [b["generation"] for p, b in bodies
                 if p == f"/api/v1/allocations/{alloc}/progress"]
        assert 7 in master.completed, master.completed
        assert sorted(reports) == list(range(1, ELASTIC_STEPS + 1)), reports
        assert beats[-1] == 1 and 0 in beats, beats
        assert ledger["ledger_resizes"] >= 1, ledger
        assert ledger["resize_lost_s"] > 0, ledger
        assert ledger["ledger_restarts"] == 0, ledger
        # the survivor's steps on both legs: the mono pair, 12 + 12 a step
        gens = counts["generations"]
        assert gens[0] == 0 and gens[-1] == 1, gens
        assert gens.count(1) == ELASTIC_STEPS - ELASTIC_SAVE_AT, gens
        for i, step in enumerate(counts["per_step"]):
            got = {n: v for n, v in step.items() if v}
            assert got == {"flash_fwd_mono": 12, "flash_bwd_mono": 12}, (
                i, step)
        launches = dict(counts["launches"])
        assert not os.path.exists(outs[1])  # SIGKILLed: no exit handler ran
        uuid2 = by_step(store)[ELASTIC_SAVE_AT]
        # one device, restored from the same checkpoint
        ctx = core._dummy_init(checkpoint_storage=store)
        one = Trainer(SyntheticTrial(hp), ctx)
        before = {n: k.launches for n, k in _build.KERNELS.items()}
        one.fit(max_length=Batch(ELASTIC_STEPS), report_period=Batch(1),
                latest_checkpoint=uuid2)
        for n, k in _build.KERNELS.items():
            launches[n] += k.launches - before[n]
        one_losses = [m["loss"] for g, _, m in ctx.train._reported
                      if g == "training"]
        survivor = [reports[s]["loss"]
                    for s in range(ELASTIC_SAVE_AT + 1, ELASTIC_STEPS + 1)]
        resize_err = close(survivor, one_losses, "survivor vs one device")
        del one, ctx
        torch.cuda.empty_cache()
        resize_s = time.perf_counter() - t0
        rec = dict(
            backend_before="gloo", ranks_before=2, fsdp_before=2,
            backend_after="nccl", ranks_after=1, generation=1,
            kill_to_exit_s=t_exit - t_kill,
            drain_to_resume_s=ledger["resize_lost_s"],
            restore_s=counts["restores"][-1],
            survivor_max_rel_loss_vs_one_device=resize_err,
            goodput_pct=ledger.get("goodput_pct"),
            mono_launches_per_step=counts["per_step"][-1],
            steps_before=gens.count(0), steps_after=gens.count(1),
            seconds=resize_s)
        self.report("elastic", "gpt2-small bf16 fsdp=2 gloo -> 1 rank nccl",
                    rec)
        master.stop()

        # -- restore only: phase tensor's saves onto other layouts ----------
        t1 = time.perf_counter()
        trial = lambda: RepeatedBatchTrial(  # noqa: E731
            8, 1024, config=RUNGS["headline"][1])

        def one_device(directory, uuid_, step):
            ctx = core._dummy_init(checkpoint_storage=directory)
            trainer = Trainer(trial(), ctx)
            trainer._restore_with_fallback(uuid_)
            trainer.fit(max_length=Batch(step + 1), report_period=Batch(1))
            return [m for g, _, m in ctx.train._reported
                    if g == "training"][-1]["loss"]

        t2_dir, t2_step = self.tensor_saves["headline-t2"]
        t2_uuid = by_step(t2_dir)[t2_step]
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=300),
            device_id=torch.device("cuda", 0))
        try:
            ctx = core._dummy_init(checkpoint_storage=t2_dir)
            meshed = Trainer(trial(), ctx,
                             mesh=make_mesh(MeshConfig(data=1, fsdp=1)))
            t_r = time.perf_counter()
            meshed._restore_with_fallback(t2_uuid)
            torch.cuda.synchronize()
            t2_restore_s = time.perf_counter() - t_r
            before = {n: k.launches for n, k in _build.KERNELS.items()}
            meshed.fit(max_length=Batch(t2_step + 1), report_period=Batch(1))
            t2_launches = {n: k.launches - before[n]
                           for n, k in _build.KERNELS.items()}
            t2_loss = [m for g, _, m in ctx.train._reported
                       if g == "training"][-1]["loss"]
            del meshed, ctx
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        t2_err = close([t2_loss], [one_device(t2_dir, t2_uuid, t2_step)],
                       "tensor=2 save onto one rank")
        for n, v in t2_launches.items():
            launches[n] += v
        assert {n: v for n, v in t2_launches.items() if v} == {
            "flash_fwd_mono": 12, "flash_bwd_mono": 12}, t2_launches

        c_dir, c_step = self.tensor_saves["headline-c2t2-ring"]
        c_uuid = by_step(c_dir)[c_step]
        port = free_port()
        outs = [os.path.join(tmp, f"fsdp2-rank{r}.json") for r in range(2)]
        logs = [tempfile.TemporaryFile() for _ in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", ELASTIC_RANK, str(r), str(port), outs[r],
             c_dir, c_uuid, str(c_step)], stdout=logs[r],
            stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
            for r in range(2)]
        try:
            codes = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks = []
        for r, code in enumerate(codes):
            logs[r].seek(0)
            assert code == 0, (r, logs[r].read().decode()[-4000:])
            logs[r].close()
            with open(outs[r]) as f:
                ranks.append(json.load(f))
        assert ranks[0]["loss"] == ranks[1]["loss"], ranks
        # the blocks at fsdp=2: wqkv [12, 384, 3, 12, 64] a rank
        assert [12, 384, 3, 12, 64] in ranks[0]["held"], ranks[0]["held"]
        c_err = close([ranks[0]["loss"]], [one_device(c_dir, c_uuid, c_step)],
                      "context=2 x tensor=2 save onto fsdp=2")
        for x in ranks:
            got = {n: v for n, v in x["launches"].items() if v}
            assert got == {"flash_fwd_mono": 12, "flash_bwd_mono": 12}, x
            for n, v in x["launches"].items():
                launches[n] += v
        self.report("elastic", "restore onto another layout", dict(
            t2_onto_one_rank_nccl_max_rel_loss=t2_err,
            t2_onto_one_rank_restore_s=t2_restore_s,
            c2t2_onto_fsdp2_gloo_max_rel_loss=c_err,
            c2t2_onto_fsdp2_restore_s=[x["restore_s"] for x in ranks],
            seconds=time.perf_counter() - t1))
        shutil.rmtree(self.tensor_tmp, ignore_errors=True)
        shutil.rmtree(tmp, ignore_errors=True)
        self.report("elastic", "phase", dict(
            seconds=time.perf_counter() - t0))
        return launches

    # -- phase 22: the experts ----------------------------------------------------
    def experts_phase(self):
        """GPT-2-small with a top-1 expert MLP in every block
        (``EXPERT_FIELDS``) on the headline trial: ``EXPERT_STEPS`` steps on
        one device through the index dispatch with the kernels, held
        against the dense dispatch (the plain version, the reference's
        one-hot einsums) on the card: the first loss bit for bit, every loss
        within 1e-3 relative, every grad norm within ``GRAD_NORM_RTOL``,
        the mono pair once per layer and step; then the gangs of
        ``EXPERT_GANGS`` over gloo (``expert=2`` on two ranks, ``expert=2
        × tensor=2`` and ``expert=2 × context=2`` by the ring on four),
        each against the one-device run: every loss within 1e-3, the first
        ``EXPERT_NORM_STEPS`` grad norms within ``GRAD_NORM_RTOL``
        (``SPLIT_NORM_STEPS`` for the tensor and context splits, whose
        rounding flips routing at step 1), every rank alike, the flash launches exact per step and rank, a rank's
        resident state below one device's (below ``expert=2``'s with the
        tensor split, as much with the context split, which splits no
        parameter); a run's sharded save restored bit for bit by a fresh
        gang (the audit every step finding nothing) and onto one rank,
        which trains on with the gang's losses; the fp32 twins of the
        tensor and context splits (``EXPERT_FP32_TWINS``, 2 layers)
        against a one-device fp32 run at that depth, every loss within
        ``FP32_LOSS_RTOL`` and the first ``EXPERT_NORM_STEPS`` grad norms
        within ``FP32_NORM_RTOL``; then a greedy decode
        through ``GenerationEngine``, the index dispatch's streams the
        dense dispatch's. Prints each layer's share of dropped tokens
        beside the one device's. → launches."""
        import shutil
        import tempfile

        import numpy as np
        import torch

        from determined_tpu_torch import core
        from determined_tpu_torch.models import gpt
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.serving import (GenerationEngine,
                                                  ServingConfig)
        from determined_tpu_torch.trainer import Batch, Trainer
        from determined_tpu_torch.trainer.profile import (RUNGS,
                                                          RepeatedBatchTrial)

        close = close_rel
        t0 = time.perf_counter()
        b, s = 8, 1024
        cfg = dataclasses.replace(RUNGS["headline"][1], **EXPERT_FIELDS)
        n = cfg.n_layers
        one, launches = {}, {}
        for dispatch in ("index", "dense"):
            held = {"drops": []}

            def prepare(trainer, dispatch=dispatch, held=held):
                trainer.model.moe_dispatch = dispatch
                held["model"] = trainer.model
                step_fn = trainer._train_step

                def step(batch, poison=1.0):
                    out = step_fn(batch, poison)
                    held["drops"].append(
                        {str(i): int(d) / t for i, (d, t) in
                         sorted(trainer.model.moe_drops.items())})
                    return out

                trainer._train_step = step

            reports, per_step, run, peak_gb, _ = self.fit_counted(
                RepeatedBatchTrial(b, s, config=cfg), EXPERT_STEPS,
                prepare=prepare)
            model = held.pop("model")
            for i, step in enumerate(per_step):
                got = {k: v for k, v in step.items() if v}
                assert got == {"flash_fwd_mono": n, "flash_bwd_mono": n}, (
                    dispatch, i, step)
            one[dispatch] = dict(
                losses=[m["loss"] for m in reports],
                grad_norms=[m["grad_norm"] for m in reports],
                rec=self.train_record(reports, run, peak_gb, cfg, b, s,
                                      warm=1),
                drops={str(i): int(d) / t for i, (d, t) in
                       sorted(model.moe_drops.items())},
                drops_by_step=held["drops"],
                n_params=sum(p.numel() for p in model.parameters()))
            if dispatch == "index":
                launches = dict(run)
            del model
            torch.cuda.empty_cache()
        index, dense = one["index"], one["dense"]
        assert index["losses"][-1] < index["losses"][0], index["losses"]
        first_bitwise = index["losses"][0] == dense["losses"][0]
        assert first_bitwise, (index["losses"][0], dense["losses"][0])
        dense_err = close(index["losses"], dense["losses"], "index vs dense")
        # the first step's gradient, from the same parameters, within
        # rounding; later grad norms part as routing decisions flip
        dense_norm_err = close(index["grad_norms"][:1],
                               dense["grad_norms"][:1],
                               "index vs dense first grad norm")
        # params and the AdamW moments, fp32
        state_gb = 3 * 4 * index["n_params"] / 1e9
        self.report("experts", "gpt2-small-moe8 bf16 one device", dict(
            index["rec"], n_params=index["n_params"], state_gb=state_gb,
            losses=index["losses"], dense_losses=dense["losses"],
            grad_norms=index["grad_norms"],
            dense_grad_norms=dense["grad_norms"],
            dense_dispatch_step_ms_median=dense["rec"]["step_ms_median"],
            first_loss_bitwise_vs_dense=first_bitwise,
            max_rel_loss_vs_dense=dense_err,
            max_rel_grad_norm_vs_dense=dense_norm_err,
            dropped_share_by_layer=index["drops"]))

        # -- the fp32 twins' one-device run: 2 layers, every expert -------------
        cfg32 = dataclasses.replace(cfg, **dict(EXPERT_FP32_FIELDS,
                                                dtype=torch.float32))
        n32 = cfg32.n_layers
        drops32 = []

        def prepare32(trainer):
            step_fn = trainer._train_step

            def step(batch, poison=1.0):
                out = step_fn(batch, poison)
                drops32.append({str(i): int(d) / t for i, (d, t) in
                                sorted(trainer.model.moe_drops.items())})
                return out

            trainer._train_step = step

        reports32, per_step32, run32, _, _ = self.fit_counted(
            RepeatedBatchTrial(b, s, config=cfg32), EXPERT_GANG_STEPS,
            prepare=prepare32)
        for i, step in enumerate(per_step32):
            got = {k: v for k, v in step.items() if v}
            assert got == {"flash_fwd_mono": n32, "flash_bwd_mono": n32}, (
                "fp32 one device", i, step)
        for k, v in run32.items():
            launches[k] = launches.get(k, 0) + v
        one32 = dict(losses=[m["loss"] for m in reports32],
                     grad_norms=[m["grad_norm"] for m in reports32])
        torch.cuda.empty_cache()

        # -- the gangs: expert=2 on two ranks, × tensor=2 and × context=2
        # -- on four (and the fp32 twins), on the one card ----------------------
        tmp = tempfile.mkdtemp(prefix="dtpu-experts-")
        results, seconds = self.gang_runs(tmp, "experts", None, [
            dict(name=name, world=r[0], mesh=r[1], data="tokens",
                 fields=EXPERT_FIELDS, steps=EXPERT_GANG_STEPS,
                 save_at=r[2])
            for name, r in EXPERT_GANGS.items()] + [
            dict(name=twin, world=EXPERT_GANGS[of][0],
                 mesh=EXPERT_GANGS[of][1], data="tokens",
                 fields=EXPERT_FP32_FIELDS, steps=EXPERT_GANG_STEPS,
                 save_at=0)
            for twin, of in EXPERT_FP32_TWINS.items()])
        expert2_state = None
        for name, (world, sizes, save_at, calls, files_in, norm_steps) in \
                EXPERT_GANGS.items():
            ranks = results[name]
            assert len(ranks) == world, (name, ranks)
            rec = dict(backend="gloo", ranks=world, **sizes,
                       steps=EXPERT_GANG_STEPS, one_device_state_gb=state_gb,
                       one_device_step1_dropped_share_by_layer=index[
                           "drops_by_step"][0])
            shares = []
            for x in ranks:
                r = x["rank"]
                assert x["losses"] == ranks[0]["losses"], (name, x)
                assert x["grad_norms"] == ranks[0]["grad_norms"], (name, x)
                ci = x["coordinate"][4]
                per_layer = ci + 1 if calls == "ring" else 1
                want = {"flash_fwd_mono": n * per_layer,
                        "flash_bwd_mono": n * per_layer}
                for i, step in enumerate(x["per_step"]):
                    got = {k: v for k, v in step.items() if v}
                    assert got == want, (name, r, i, step, want)
                    for k, v in step.items():
                        launches[k] = launches.get(k, 0) + v
                # one device's state; a tensor split holds less than
                # expert=2's, a context split (no parameter split) as much
                limit = state_gb if expert2_state is None else expert2_state
                assert (x["state_gb"] < limit if "context" not in sizes
                        else x["state_gb"] <= limit * 1.001), (
                    name, r, x["state_gb"], limit)
                if save_at:
                    assert x["resume_bitwise"], (name, r)
                    assert x["resumed_losses"] == x["losses"][save_at:], (
                        name, r)
                    assert x["audits"] == list(
                        range(1, EXPERT_GANG_STEPS + 1)), (name, x)
                # the tokens of (data, fsdp, context): tensor and expert
                # ranks share them
                if x["coordinate"][3] == 0 and x["coordinate"][5] == 0:
                    shares.append(x["moe_drop_share_by_step"][0])
                for key in ("state_gb", "peak_gb", "reserved_gb"):
                    rec[f"rank{r}_{key}"] = x[key]
                rec[f"rank{r}_step_ms"] = x["step_ms"]
                rec[f"rank{r}_launches_per_step"] = want
            x = ranks[0]
            if name == "expert2":
                expert2_state = x["state_gb"]
            for f in files_in:
                assert f in x.get("files", []), (name, f, x.get("files"))
            rec.update(
                losses=x["losses"],
                max_rel_loss_vs_one_device=close(
                    x["losses"], index["losses"], f"{name} vs one device"),
                # every step's reading, the held ones asserted
                rel_grad_norm_by_step=[
                    abs(a - b) / abs(b) for a, b in zip(x["grad_norms"],
                                                        index["grad_norms"])],
                grad_norm_steps_held=norm_steps,
                max_rel_grad_norm_vs_one_device=close(
                    x["grad_norms"][:norm_steps],
                    index["grad_norms"], f"{name} grad norm vs one device",
                    GRAD_NORM_RTOL),
                grad_norms=x["grad_norms"],
                one_device_grad_norms=index["grad_norms"],
                step1_dropped_share_by_layer={
                    k: sum(s[k] for s in shares) / len(shares)
                    for k in shares[0]},
                rotations_per_step=x["rotations_per_step"],
                collectives_per_step=x["collectives_per_step"],
                collective_mb_per_step=x["collective_mb_per_step"],
                gang_seconds=seconds[world])
            if save_at:
                # the gang's save onto one rank
                ctx = core._dummy_init(
                    checkpoint_storage=os.path.join(tmp, f"ckpt{world}"))
                trainer = Trainer(RepeatedBatchTrial(b, s, config=cfg), ctx)
                trainer.fit(max_length=Batch(EXPERT_GANG_STEPS),
                            report_period=Batch(1),
                            latest_checkpoint=x["save_id"])
                restored = [m["loss"] for g, _, m in ctx.train._reported
                            if g == "training"]
                assert len(restored) == EXPERT_GANG_STEPS - save_at, restored
                rec["ckpt_files"] = len(x["files"])
                rec["restored_one_rank_losses"] = restored
                rec["max_rel_loss_restored_vs_gang"] = close(
                    restored, x["losses"][save_at:],
                    f"{name} restored onto one rank")
                del trainer
                torch.cuda.empty_cache()
            self.report("experts", f"gpt2-small-moe8 bf16 {name}", rec)

        # -- the fp32 twins against the fp32 one-device run: every loss, the
        # -- first EXPERT_NORM_STEPS grad norms --------------------------------
        for twin, of in EXPERT_FP32_TWINS.items():
            world, sizes, _, calls, _, _ = EXPERT_GANGS[of]
            ranks = results[twin]
            assert len(ranks) == world, (twin, ranks)
            shares = []
            for x in ranks:
                assert x["losses"] == ranks[0]["losses"], (twin, x)
                assert x["grad_norms"] == ranks[0]["grad_norms"], (twin, x)
                per_layer = x["coordinate"][4] + 1 if calls == "ring" else 1
                want = {"flash_fwd_mono": n32 * per_layer,
                        "flash_bwd_mono": n32 * per_layer}
                for i, step in enumerate(x["per_step"]):
                    got = {k: v for k, v in step.items() if v}
                    assert got == want, (twin, x["rank"], i, step, want)
                    for k, v in step.items():
                        launches[k] = launches.get(k, 0) + v
                if x["coordinate"][3] == 0 and x["coordinate"][5] == 0:
                    shares.append(x["moe_drop_share_by_step"])
            x = ranks[0]
            rel_loss = [abs(a - c) / abs(c)
                        for a, c in zip(x["losses"], one32["losses"])]
            rel_norm = [abs(a - c) / abs(c) for a, c in
                        zip(x["grad_norms"], one32["grad_norms"])]
            # every step's reading printed before the holds are asserted
            self.report("experts", f"gpt2-small-moe8 fp32 2 layers {twin}",
                        dict(
                backend="gloo", ranks=world, **sizes, layers=n32,
                dtype="float32", steps=EXPERT_GANG_STEPS, losses=x["losses"],
                one_device_losses=one32["losses"], rel_loss_by_step=rel_loss,
                grad_norms=x["grad_norms"],
                one_device_grad_norms=one32["grad_norms"],
                rel_grad_norm_by_step=rel_norm,
                grad_norm_steps_held=EXPERT_NORM_STEPS,
                dropped_share_by_step=[
                    {k: sum(sh[i][k] for sh in shares) / len(shares)
                     for k in shares[0][i]}
                    for i in range(EXPERT_GANG_STEPS)],
                one_device_dropped_share_by_step=drops32,
                gang_seconds=seconds[world]))
            close(x["losses"], one32["losses"], f"{twin} vs one device fp32",
                  FP32_LOSS_RTOL)
            close(x["grad_norms"][:EXPERT_NORM_STEPS], one32["grad_norms"],
                  f"{twin} grad norm vs one device fp32", FP32_NORM_RTOL)
        shutil.rmtree(tmp, ignore_errors=True)

        # -- a greedy decode, index against dense dispatch -----------------------
        model = gpt.GPT(cfg)
        scfg = ServingConfig.from_dict({**ENGINE_CFG,
                                        "max_new_tokens": EXPERT_TOKENS})
        rng = np.random.default_rng(2)
        prompts = [list(rng.integers(1, cfg.vocab_size, size=int(k)))
                   for k in rng.integers(64, 481, size=4)]
        streams, engine_launches = {}, {}
        for dispatch in ("index", "dense"):
            model.moe_dispatch = dispatch
            eng = GenerationEngine(model, None, scfg)
            before = {k: v.launches for k, v in _build.KERNELS.items()}
            eng.start()
            try:
                res = [r.result(timeout=600) for r in
                       [eng.submit(p, max_new_tokens=EXPERT_TOKENS)
                        for p in prompts]]
            finally:
                eng.stop()
            assert all(r["reason"] == "length" for r in res), res
            streams[dispatch] = [r["tokens"] for r in res]
            engine_launches[dispatch] = {
                k: v.launches - before[k] for k, v in _build.KERNELS.items()
                if v.launches != before[k]}
            if dispatch == "index":
                # the last decode iteration's drops (capacity from its
                # slots, padding included)
                decode_drops = {str(i): int(d) / t for i, (d, t) in
                                sorted(model.moe_drops.items())}
            del eng
        assert streams["index"] == streams["dense"], streams
        assert engine_launches["index"].get("paged_attention", 0) > 0
        assert engine_launches["index"].get("flash_fwd", 0) > 0
        for k, v in engine_launches["index"].items():
            launches[k] = launches.get(k, 0) + v
        torch.cuda.empty_cache()
        self.report("experts", "gpt2-small-moe8 bf16 greedy decode", dict(
            prompts=len(prompts), tokens_per_stream=EXPERT_TOKENS,
            identical_streams=True, launches=engine_launches["index"],
            last_decode_dropped_share_by_layer=decode_drops,
            seconds=time.perf_counter() - t0))
        del model
        torch.cuda.empty_cache()
        return launches

    # -- phase 23: pipeline stages ------------------------------------------------
    def pipeline_phase(self):
        """GPT-2-small on the headline trial through the pipeline
        schedules, gangs on the one card over gloo (``PIPELINE_RUNS``),
        each run held against phase train's one-device losses (1e-3) and
        the grad norms of its first ``PIPELINE_NORM_STEPS`` steps
        (``GRAD_NORM_RTOL``), every rank alike; per step
        and rank the mono launches the schedule implies (the stage's L/S
        layers × M microbatches, twice in the forward under 1F1B, which
        recomputes each stage input's forward in its backward; on the ring
        i + 1 flash calls a layer on context rank i), the 1F1B stash's
        high-water mark (stage d: min(M, 2(S−1−d)+1) ≤ min(M, 2S−1)), the
        step's wall time and the resident state. → launches."""
        import shutil
        import tempfile

        import numpy as np

        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix="dtpu-pipeline-")
        results, seconds = self.gang_runs(tmp, "pipeline", None, [
            dict(name=name, world=r[0], mesh=r[1], data="tokens",
                 fields=r[2], steps=r[3], save_at=0)
            for name, r in PIPELINE_RUNS.items()])
        shutil.rmtree(tmp, ignore_errors=True)
        launches = {}
        for name, (world, sizes, fields, steps) in PIPELINE_RUNS.items():
            ranks = results[name]
            assert len(ranks) == world, (name, len(ranks))
            n_stages = sizes["pipeline"]
            m = fields["num_microbatches"]
            per = 12 // n_stages
            ofob = fields["pipeline_schedule"] == "1f1b"
            bound = min(m, 2 * n_stages - 1)
            rec = dict(backend="gloo", ranks=world, **sizes, steps=steps,
                       batch=8, seq=1024, microbatches=m, **fields)
            for x in ranks:
                r = x["rank"]
                d, ci = x["coordinate"][0], x["coordinate"][4]
                assert x["losses"] == ranks[0]["losses"], (name, x)
                assert x["grad_norms"] == ranks[0]["grad_norms"], (name, x)
                calls = ci + 1 if sizes.get("context", 1) > 1 else 1
                want = {"flash_fwd_mono": per * m * calls * (2 if ofob
                                                             else 1),
                        "flash_bwd_mono": per * m * calls}
                for i, step in enumerate(x["per_step"]):
                    got = {k: v for k, v in step.items() if v}
                    assert got == want, (name, r, i, step, want)
                    for k, v in step.items():
                        launches[k] = launches.get(k, 0) + v
                if ofob:
                    high = min(m, 2 * (n_stages - 1 - d) + 1)
                    assert x["stash_high_water"] == [high] * steps, (name, x)
                    assert high <= bound
                else:
                    assert x["stash_high_water"] == [-1] * steps, (name, x)
                rec[f"rank{r}_stage"] = d
                rec[f"rank{r}_step_ms"] = x["step_ms"]
                rec[f"rank{r}_launches_per_step"] = want
                rec[f"rank{r}_stash_high_water"] = x["stash_high_water"]
                rec[f"rank{r}_state_gb"] = x["state_gb"]
                rec[f"rank{r}_peak_gb"] = x["peak_gb"]
                rec[f"rank{r}_p2p_mb_per_step"] = x["p2p_mb_per_step"]
            x = ranks[0]
            rec.update(
                loss_first=x["losses"][0], loss_last=x["losses"][-1],
                step_ms_median=float(np.median(x["step_ms"][1:])),
                max_rel_loss_vs_one_device=close_rel(
                    x["losses"], self.train_losses, f"{name} vs one device"),
                max_rel_grad_norm_vs_one_device=close_rel(
                    x["grad_norms"][:PIPELINE_NORM_STEPS],
                    self.train_grad_norms, f"{name} grad norm vs one device",
                    GRAD_NORM_RTOL),
                grad_norms=x["grad_norms"],
                stash_bound=bound if ofob else None,
                collectives_per_step=x["collectives_per_step"],
                collective_mb_per_step=x["collective_mb_per_step"])
            self.report("pipeline", f"gpt2-small bf16 {name}", rec)
        self.report("pipeline", "phase", dict(
            gang2_seconds=seconds[2], gang4_seconds=seconds[4],
            seconds=time.perf_counter() - t0))
        return launches

    def zoo_phase(self):
        """The generative pair through the exec layer on the card:
        ``DiffusionTrial`` and ``DCGANTrial`` (``ZOO_TRIALS``) by
        ``harness.run`` at their example configs' hyperparameters
        (``examples/diffusion.json``, ``dcgan.json``: 32 × 32, 1 channel,
        batch 64, 200 timesteps, lr 2e-4), ``ZOO_STEPS`` steps on one rank
        with shared-fs storage (the examples' ``mesh`` ``data: 8`` and
        ``gcs`` storage left out) and checkpoints at ``ZOO_SAVE_AT`` and
        the end: finite losses, the DDPM's falling; the save restored into
        a fresh trainer bit for bit, and the run resumed from it through
        the harness within 1e-3 of the uninterrupted one; 16 images
        sampled over the 200 steps, finite; the card's loss and gradients
        at fixed parameters and draws against the port's CPU run
        (``zoo_parity``: fp32 loss, fp64 loss and gradient, 1e-4
        relative; TF32 off in cuDNN and matmuls, as ``main`` sets it).
        Prints the step ms and the sample's seconds.
        No kernel of the port runs here (the convolutions are library
        calls, as the reference's). → launches (none)."""
        import shutil
        import tempfile

        import numpy as np
        import torch

        from determined_tpu_torch import core
        from determined_tpu_torch.examples import generative_trials as gt
        from determined_tpu_torch.trainer import Trainer

        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        t0 = time.perf_counter()
        root = os.path.dirname(os.path.abspath(__file__))
        tmp = tempfile.mkdtemp(prefix="chip-smoke-zoo-")
        try:
            for name, (cls, example, metric) in ZOO_TRIALS.items():
                with open(os.path.join(root, "examples", example)) as f:
                    hp = json.load(f)["hyperparameters"]
                store = os.path.join(tmp, name)
                entry = f"determined_tpu_torch.examples.generative_trials:{cls}"
                cfg = {"searcher": {"name": "single", "metric": metric,
                                    "max_length": {"batches": ZOO_STEPS}},
                       "min_checkpoint_period": {"batches": ZOO_SAVE_AT},
                       "scheduling_unit": 1}
                rc, _, launches, run_a, wall_a = self.harness_run(
                    entry, hp, cfg, f"chip-smoke-zoo-{name}-a", store)
                assert rc == 0, (name, rc)
                assert not any(launches.values()), (name, launches)
                steps = list(range(1, ZOO_STEPS + 1))
                assert sorted(run_a) == steps, (name, sorted(run_a))
                losses = [run_a[s]["loss"] for s in steps]
                assert all(np.isfinite(losses)), (name, losses)
                head, tail = (float(np.mean(losses[:10])),
                              float(np.mean(losses[-10:])))
                if name == "ddpm":
                    assert tail < head, (name, head, tail)
                ckpts = {}
                for d in os.listdir(store):
                    md = os.path.join(store, d, "metadata.json")
                    if os.path.exists(md):
                        with open(md) as f:
                            ckpts[json.load(f)["steps_completed"]] = d
                assert sorted(ckpts) == [ZOO_SAVE_AT, ZOO_STEPS], ckpts
                # the save, restored into a fresh trainer bit for bit
                trial = getattr(gt, cls)(hp)
                trainer = Trainer(trial, core._dummy_init(
                    checkpoint_storage=store))
                trainer._restore_with_fallback(ckpts[ZOO_SAVE_AT])
                saved = os.path.join(store, ckpts[ZOO_SAVE_AT])
                bitwise = all(
                    np.array_equal(p.detach().cpu().numpy(), np.load(
                        os.path.join(saved, "params__"
                                     + n.replace(".", "__") + ".npy")))
                    for n, p in trainer.model.named_parameters())
                assert bitwise, name
                assert trainer.steps_completed == ZOO_SAVE_AT
                rec = dict(
                    trial=cls, steps=ZOO_STEPS, batch=hp["batch_size"],
                    lr=hp["lr"], **hp["model_config"], rc=0,
                    loss_first=losses[0], loss_last=losses[-1],
                    loss_mean_first10=head, loss_mean_last10=tail,
                    step_ms_median=float(np.median(
                        [1e3 / run_a[s]["batches_per_second"]
                         for s in steps[2:] if s != ZOO_SAVE_AT + 1])),
                    wall_s=wall_a, restored_bitwise=True)
                if name == "dcgan":
                    rec.update(g_loss_last=run_a[ZOO_STEPS]["g_loss"],
                               d_loss_last=run_a[ZOO_STEPS]["d_loss"])
                # resumed from the save through the harness
                rc, _, _, run_b, _ = self.harness_run(
                    entry, hp, cfg, f"chip-smoke-zoo-{name}-b", store,
                    DTPU_LATEST_CHECKPOINT=ckpts[ZOO_SAVE_AT])
                assert rc == 0, (name, rc)
                assert sorted(run_b) == steps[ZOO_SAVE_AT:], sorted(run_b)
                rec["resumed_loss_max_rel"] = close_rel(
                    [run_b[s]["loss"] for s in steps[ZOO_SAVE_AT:]],
                    losses[ZOO_SAVE_AT:], f"{name} resumed")
                if name == "ddpm":
                    trainer._restore_with_fallback(ckpts[ZOO_STEPS])
                    gen = torch.Generator(device=self.dev).manual_seed(0)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    images = trainer.model.sample(ZOO_SAMPLES, gen)
                    torch.cuda.synchronize()
                    rec["sample_s"] = time.perf_counter() - t1
                    c = trainer.model.config
                    assert images.shape == (ZOO_SAMPLES, c.image_size,
                                            c.image_size, c.channels)
                    assert bool(torch.isfinite(images).all()), name
                    rec.update(samples=ZOO_SAMPLES, sample_steps=c.timesteps,
                               sample_abs_mean=float(images.abs().mean()))
                rec.update(self.zoo_parity(trainer.model, hp))
                del trainer
                torch.cuda.empty_cache()
                self.report("zoo", name, rec)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.report("zoo", "phase", dict(seconds=time.perf_counter() - t0))
        return {}

    def zoo_parity(self, model, hp):
        """`model`'s loss and gradients on the card against a CPU copy of
        it, at its parameters and one set of draws made on the CPU
        (``loss_given``): in fp32 the loss within 1e-4 relative; in fp64
        (both sides cast) the loss and the whole gradient within 1e-4
        relative (L2) → those, and the fp32 gradient's L2 difference and
        its entries past 1e-4 of the gradient's largest, printed. The
        fp32 gradients are not held: a pre-activation within fp32
        rounding of a (leaky) ReLU's kink takes one slope on the card and
        the other on the CPU and moves a share of the upstream gradient
        (DCGAN: 1.9e-4 of a largest 1.14 on ``disc.c2.b`` in one call,
        1.36e-4 relative in L2 in another, 3e-7 in most); in fp64 no
        pre-activation comes that close."""
        import copy

        import torch

        from determined_tpu_torch.examples.generative_trials import (
            _synthetic_images,
        )

        c = model.config
        batch = next(_synthetic_images(3, hp["batch_size"], c.image_size,
                                       c.channels))
        gen = torch.Generator().manual_seed(5)
        image = torch.from_numpy(batch["image"])
        if hasattr(model, "sample_given"):   # DDPM: t and ε
            draws = (image, torch.randint(0, c.timesteps, (len(image),),
                                          generator=gen),
                     torch.randn(image.shape, generator=gen))
        else:                                # DCGAN: z
            draws = (image, torch.randn((len(image), c.latent_dim),
                                        generator=gen))
        out = {}
        for dtype in (torch.float32, torch.float64):
            for where, dev in (("card", model.device), ("cpu", "cpu")):
                m = copy.deepcopy(model).to(dev, dtype)
                loss, _ = m.loss_given(*(
                    x.to(dev, dtype) if x.is_floating_point() else x.to(dev)
                    for x in draws))
                grads = torch.autograd.grad(loss, list(m.parameters()))
                out[where, dtype] = (float(loss.detach()), torch.cat(
                    [g.detach().double().cpu().reshape(-1) for g in grads]))
                del m
        rec = dict(tf32=False)
        for dtype, tag in ((torch.float32, "fp32"), (torch.float64, "fp64")):
            (loss_c, g_c), (loss_p, g_p) = (out["card", dtype],
                                            out["cpu", dtype])
            loss_rel = abs(loss_c - loss_p) / abs(loss_p)
            assert loss_rel <= 1e-4, (tag, loss_c, loss_p)
            diff = g_c - g_p
            grad_rel = float(diff.norm() / g_p.norm())
            rec.update({f"{tag}_loss_rel": loss_rel,
                        f"{tag}_grad_l2_rel": grad_rel,
                        f"{tag}_entries_past_1e4": int(
                            (diff.abs() > 1e-4 * g_p.abs().max()).sum())})
        assert rec["fp64_grad_l2_rel"] <= 1e-4, rec
        rec.update(card_loss=out["card", torch.float32][0],
                   cpu_loss=out["cpu", torch.float32][0])
        return rec

    def autotune_phase(self):
        """``ops/flash_autotune.py`` on the card, with its cache in a temp
        dir: ``tune_flash_blocks`` at each of ``AUTOTUNE_SHAPES``, one
        probe a distinct route (each route timed at its first candidate,
        four launches of its kernels), the first candidate of the fastest
        route returned; a second call reads the cache and launches no
        kernel. Then GPT-2-small with ``flash_autotune`` (the headline
        trial): its build resolves its per-device blocks (S 1024, H 12)
        from the cache, launching nothing, and each step launches the
        winner's route once a layer; ``tune_paged_block_h`` returns the
        default and launches nothing. Prints each candidate's route and
        ms. → launches (the probes' and the steps')."""
        import shutil
        import tempfile

        import numpy as np
        import torch

        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.ops import flash_autotune as fat
        from determined_tpu_torch.ops.paged_attention import (
            default_paged_block_h,
        )
        from determined_tpu_torch.trainer.profile import (RUNGS,
                                                          RepeatedBatchTrial)

        t0 = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix="chip-smoke-autotune-")
        cache = os.path.join(tmp, "flash_blocks.json")
        env0 = os.environ.get("DTPU_FLASH_TUNE_CACHE")
        os.environ["DTPU_FLASH_TUNE_CACHE"] = cache
        probe, timed = fat._probe_ms, []

        def recording(bq, bk, **kw):
            ms = probe(bq, bk, **kw)
            timed.append(((bq, bk), ms))
            return ms

        def counts():
            return {n: k.launches for n, k in _build.KERNELS.items()}

        def tune(**kw):
            before = counts()
            got = fat.tune_flash_blocks(**kw)
            return got, {n: v - before[n] for n, v in counts().items()}

        def route_launches(routes):
            want = {}
            for fwd, bwd in routes:
                for k in (fwd, *ROUTE_KERNELS[bwd]):
                    want[k] = want.get(k, 0) + (fat._PROBE_WARMUP
                                                + fat._PROBE_STEPS)
            return want

        launches = dict.fromkeys(_build.KERNELS, 0)
        fat._probe_ms = recording
        try:
            for name, shape in AUTOTUNE_SHAPES.items():
                kw = dict(n_heads=12, head_dim=64, dtype=torch.bfloat16,
                          causal=True, device=self.dev, **shape)
                timed.clear()
                best, run = tune(**kw)
                s_q = shape["s_q"]
                cands = fat.candidate_blocks(s_q, s_q)
                routes = {c: fat.candidate_route(
                    *c, s_q=s_q, s_k=s_q, n_heads=12, head_dim=64,
                    batch=shape["batch"],
                    segments=shape.get("segments", False)) for c in cands}
                firsts = {}
                for c in cands:
                    firsts.setdefault(routes[c], c)
                assert [c for c, _ in timed] == list(firsts.values()), (
                    name, timed, firsts)
                ms = {routes[c]: t for c, t in timed}
                assert all(np.isfinite(list(ms.values()))), (name, ms)
                assert best == firsts[min(ms, key=ms.get)], (name, best, ms)
                got = {k: v for k, v in run.items() if v}
                assert got == route_launches(ms), (name, got, ms)
                for k, v in run.items():
                    launches[k] += v
                for c in cands:
                    print(f"  autotune {name}: blocks {c} route "
                          f"{'+'.join(routes[c])} ms={ms[routes[c]]:.6g}",
                          flush=True)
                timed.clear()
                again, cached = tune(**kw)
                assert again == best and not timed, (name, again, timed)
                assert not any(cached.values()), (name, cached)
                self.report("autotune", f"{name} H12 D64 causal bf16", dict(
                    winner=list(best), route="+".join(routes[best]),
                    candidates=len(cands), routes=len(ms),
                    **{f"ms_{'+'.join(r)}": t for r, t in ms.items()},
                    probe_launches=got, cached_call_launches=0))

            # -- GPT-2-small with flash_autotune: its per-device shape
            # -- (batch 1, the reference's arguments), probed, then cached --
            cfg = dataclasses.replace(RUNGS["headline"][1],
                                      flash_autotune=True)
            timed.clear()
            blocks, run = tune(
                s_q=cfg.seq_len, n_heads=cfg.n_heads,
                head_dim=cfg.head_dim, dtype=cfg.dtype, causal=True,
                window=cfg.attn_window, want_q=cfg.flash_block_q,
                want_k=cfg.flash_block_k, device=self.dev)
            for k, v in run.items():
                launches[k] += v
            probed = {c: t for c, t in timed}
            built = {}
            before = counts()

            def prepare(trainer):
                built["blocks"] = trainer.model._flash_blocks()
                built["launches"] = {n: v - before[n]
                                     for n, v in counts().items()}

            b, s = 8, cfg.seq_len
            reports, per_step, run, _, _ = self.fit_counted(
                RepeatedBatchTrial(b, s, config=cfg), AUTOTUNE_STEPS,
                prepare=prepare)
            assert built["blocks"] == blocks, (built, blocks)
            assert not any(built["launches"].values()), built
            fwd, bwd = fat.candidate_route(
                *blocks, s_q=s, s_k=s, n_heads=cfg.n_heads,
                head_dim=cfg.head_dim, batch=b)
            want = {k: cfg.n_layers for k in (fwd, *ROUTE_KERNELS[bwd])}
            for i, step in enumerate(per_step):
                got = {k: v for k, v in step.items() if v}
                assert got == want, ("autotuned step", i, step, want)
            for k, v in run.items():
                launches[k] += v
            losses = [m["loss"] for m in reports]
            assert losses[-1] < losses[0], losses
            step_ms = [1e3 / m["batches_per_second"] for m in reports]

            # -- the paged kernel's heads per step: no probe -------------------
            before = counts()
            block_h = fat.tune_paged_block_h(
                n_heads=12, head_dim=64, page_size=128, num_pages=72,
                pages_per_slot=8, batch=8, q_rows=1, dtype=torch.bfloat16)
            assert block_h == default_paged_block_h(12, 64, 128,
                                                    torch.bfloat16)
            assert counts() == before
            self.report("autotune", "gpt2-small bf16 flash_autotune", dict(
                blocks=list(blocks), route=f"{fwd}+{bwd}",
                probed_ms={f"{c[0]}x{c[1]}": t for c, t in probed.items()},
                steps=len(reports), losses=losses, step_ms=step_ms,
                launches_per_step=want, paged_block_h=block_h,
                seconds=time.perf_counter() - t0))
        finally:
            fat._probe_ms = probe
            if env0 is None:
                os.environ.pop("DTPU_FLASH_TUNE_CACHE", None)
            else:
                os.environ["DTPU_FLASH_TUNE_CACHE"] = env0
            shutil.rmtree(tmp, ignore_errors=True)
        return launches

    def integrations_phase(self):
        """The integrations on the card: the haiku slot's trials
        (``HAIKU_TRIALS``: ``HaikuVisionTrial`` conv and mlp at their
        defaults, ``DartsBenchmarkTrial`` at ``darts_benchmark.json``'s
        fixed values) and, where ``transformers`` imports, ``HFTrial`` at
        ``hf_gpt2.json``'s GPT-2-small width (B 16 × 512, bf16) and
        ``HFClassifierTrial`` at ``bert_finetune.json``'s BERT-base width
        (``HF_TRIALS``, each on one batch of its stream, repeated):
        ``INTEGRATION_STEPS`` Trainer steps each, finite losses (the HF
        ones falling), no port kernel launched (their
        models run outside the port's kernels, as the reference's run
        outside Pallas); then each trained model's fp32 logits (the HF
        ones at B 2) against the port's CPU model holding the same
        parameters, within ``LOGIT_RTOL`` of the largest (TF32 off).
        Whether ``transformers`` imports is printed first; without it the
        HF half prints that it did not run. → launches (none)."""
        import itertools

        import numpy as np
        import torch

        from determined_tpu_torch.examples import darts_benchmark_trial
        from determined_tpu_torch.integrations import haiku

        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        t0 = time.perf_counter()
        try:
            import transformers
            hf_version = transformers.__version__
        except ImportError:
            hf_version = None
        print(f"phase integrations: transformers="
              f"{hf_version or 'missing'} | card {self.card}", flush=True)
        root = os.path.dirname(os.path.abspath(__file__))
        with open(os.path.join(root, "examples", "darts_benchmark.json")) as f:
            darts_hp = {k: v for k, v in json.load(f)["hyperparameters"].items()
                        if not isinstance(v, dict)}
        trials = {}
        for name, (cls, hp) in HAIKU_TRIALS.items():
            if cls == "DartsBenchmarkTrial":
                trials[name] = darts_benchmark_trial.DartsBenchmarkTrial(
                    dict(darts_hp, lr=DARTS_LR, **hp))
            else:
                trials[name] = haiku.HaikuVisionTrial(dict(hp))
        if hf_version is not None:
            from determined_tpu_torch.integrations import hf

            for name, (cls, example, lr) in HF_TRIALS.items():
                with open(os.path.join(root, "examples", example)) as f:
                    hp = json.load(f)["hyperparameters"]
                if lr is not None:
                    hp["lr"] = lr
                trial = trials[name] = getattr(hf, cls)(hp)
                first = next(iter(trial.build_training_data()))
                trial.build_training_data = (
                    lambda first=first: itertools.repeat(first))
        else:
            print("phase integrations: the HF trials did not run "
                  "(transformers is not installed)", flush=True)
        for name, trial in trials.items():
            held = {}
            reports, per_step, run, peak_gb, _ = self.fit_counted(
                trial, INTEGRATION_STEPS,
                prepare=lambda trainer, held=held: held.update(
                    model=trainer.model))
            assert not any(run.values()), (name, run)
            losses = [m["loss"] for m in reports]
            if name.startswith("hf-"):
                assert losses[-1] < losses[0], (name, losses)
            model = held.pop("model")
            batch = next(iter(trial.build_validation_data()))
            key = "tokens" if "tokens" in batch else "x"
            rows = 2 if name.startswith("hf-") else len(batch[key])
            x = torch.as_tensor(np.asarray(batch[key])[:rows])
            if name.startswith("hf-"):
                model.dtype = torch.float32  # the fp32 logits, no autocast
                cpu = type(model)(
                    trial.hparams.get("hf_model_type"),
                    trial.hparams.get("hf_config", {}),
                    **({"num_labels": int(trial.hparams.get("num_labels", 2))}
                       if name == "hf-bert" else {}),
                    dtype=torch.float32, device="cpu")
            else:
                cpu = trial.build_model("cpu")
            cpu.load_state_dict({k: v.detach().cpu()
                                 for k, v in model.state_dict().items()})
            with torch.no_grad():
                got = model.apply(x.to(self.dev)).float().cpu()
                want = cpu.apply(x).float()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            self.report("integrations", name, dict(
                steps=len(reports), losses=losses,
                step_ms=[1e3 / m["batches_per_second"] for m in reports],
                max_memory_allocated_gb=peak_gb,
                n_params=sum(p.numel() for p in model.parameters()),
                logits_rows=rows, fp32_logits_max_abs_err=err,
                fp32_logits_max=scale))
            assert err <= LOGIT_RTOL * scale, (name, err, scale)
            del model, cpu
            torch.cuda.empty_cache()
        self.report("integrations", "all", dict(
            trials=len(trials), transformers=hf_version or "missing",
            seconds=time.perf_counter() - t0))
        return {}

    def train_parity_phase(self, route="mono"):
        """One fp32 loss + gradient of GPT-2-small's width with 2 layers,
        batch 1 x seq 1024, on the card and on the CPU from the same
        parameters. "mono": plain tokens through the mono pair; "fused" and
        "two_pass": a packed batch with attn_window=256 through flash_fwd
        and the fused blocked backward, or (the partials cap set to 0 for
        the card's call) the dq and dk/dv passes."""
        import numpy as np
        import torch

        from determined_tpu_torch.models import gpt
        from determined_tpu_torch.ops import _build
        from determined_tpu_torch.ops import flash_attention as tfa
        from determined_tpu_torch.trainer import optim

        cfg = dataclasses.replace(gpt.small(), n_layers=2,
                                  dtype=torch.float32, remat=False)
        if route == "mono":
            batch = {"tokens": np.random.default_rng(1).integers(
                0, cfg.vocab_size, size=(1, cfg.seq_len)).astype(np.int32)}
            want = dict(flash_fwd_mono=2, flash_bwd_mono=2)
        else:
            cfg = dataclasses.replace(cfg, attn_window=256)
            batch = packed_batch(1, cfg.seq_len, 5, cfg.vocab_size)
            want = ({"flash_fwd": 2, "flash_bwd_blocked": 2}
                    if route == "fused" else
                    {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2})
        cpu = gpt.GPT(cfg, device="cpu", seed=1)
        card = gpt.GPT(cfg, device=self.dev)
        card.load_state_dict(cpu.state_dict())
        cap = tfa._FUSED_BWD_PARTIALS_CAP
        out = {}
        for where, model in (("card", card), ("cpu", cpu)):
            before = {n: k.launches for n, k in _build.KERNELS.items()}
            if where == "card" and route == "two_pass":
                tfa._FUSED_BWD_PARTIALS_CAP = 0
            try:
                loss, _ = model.loss({k: torch.from_numpy(v)
                                      for k, v in batch.items()})
                grads = torch.autograd.grad(loss, list(model.parameters()))
            finally:
                tfa._FUSED_BWD_PARTIALS_CAP = cap
            out[where] = (float(loss.detach()), float(optim.global_norm(grads)),
                          [g.detach().cpu() for g in grads])
            if where == "card":
                got = {n: k.launches - before[n]
                       for n, k in _build.KERNELS.items()
                       if k.launches != before[n]}
                assert got == want, (
                    f"the card's {route} step did not go through its "
                    f"kernels: {got}")
        (loss_c, norm_c, g_c), (loss_p, norm_p, g_p) = out["card"], out["cpu"]
        assert abs(loss_c - loss_p) <= 1e-5 * abs(loss_p), (loss_c, loss_p)
        assert abs(norm_c - norm_p) <= 1e-4 * norm_p, (norm_c, norm_p)
        worst = 0.0
        for (name, _), gc, gp in zip(card.named_parameters(), g_c, g_p):
            scale = float(gp.abs().max())
            err = float((gc - gp).abs().max())
            assert err <= 1e-4 * scale, (name, err, scale)
            worst = max(worst, err / scale if scale else 0.0)
        what = "gpt2-small-width L2 fp32 card vs cpu"
        if route != "mono":
            what += f" packed window256 {route}"
        self.report("train-parity", what,
                    dict(loss_card=loss_c, loss_cpu=loss_p,
                         grad_norm_card=norm_c, grad_norm_cpu=norm_p,
                         leaves=len(g_c), worst_leaf_rel_err=worst))


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from determined_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: run from the repo root ({exc})", file=sys.stderr)
        return 2

    # -- phase 1: device --------------------------------------------------------
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke(torch, card)
    print(f"phase device: {torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} | card {card}", flush=True)

    # -- phase 2: build ----------------------------------------------------------
    build_s = _build.build_all()
    print(f"phase build: seconds={build_s:.3f} kernels="
          f"{','.join(_build.KERNELS)}", flush=True)
    for k in _build.KERNELS.values():
        for line in k.ptxas_report():
            print(f"  ptxas {k.name}: {line}", flush=True)

    # -- phase 3: kernels against their plain versions ---------------------------
    bf16, fp32 = torch.bfloat16, torch.float32
    flash = {}
    for dtype in (bf16, fp32):
        flash[dtype] = smoke.flash_case("prefill", dtype, b=4, s_q=512,
                                        s_k=512, segs="packed")
        smoke.flash_case("gather-decode", dtype, b=8, s_q=1, s_k=1024,
                         kv_offset=1023, segs="decode", seed=1)
        smoke.flash_case("window128", dtype, b=4, s_q=512, s_k=512,
                         window=128, seed=2)
    # the serving path's other geometries: the prefix-cache tail prefill
    # (4 tails of 512 against 8 cached pages + themselves) and the
    # speculative gather verify (8 slots of 5 rows behind 8 pages)
    tail_segs = cached_tail_segments((256, 384, 896, 0), (16, 128, 512, 0),
                                     512, 1024)
    for dtype in (bf16, fp32):
        smoke.flash_case("cached-tail", dtype, b=4, s_q=512, s_k=1536,
                         kv_offset=1024, segs=tail_segs, seed=3)
        smoke.flash_case("spec-gather", dtype, b=8, s_q=5, s_k=1029,
                         kv_offset=1024, segs="spec", seed=4)
    paged = {}
    for dtype in (bf16, fp32):
        paged[dtype] = smoke.paged_case("decode", dtype, q_rows=1,
                                        ragged=False)
        smoke.paged_case("ragged-qlens", dtype, q_rows=8, ragged=True,
                         seed=1)
        for q_rows in (5, 9):   # the speculative verify, draft_len 4 and 8
            smoke.paged_case(f"spec-verify-q{q_rows}", dtype, q_rows=q_rows,
                             ragged=True, seed=q_rows, max_q_len=q_rows)
    smoke.paged_case("full", bf16, q_rows=1, ragged=False, seed=2, full=True)
    for dtype in (bf16, fp32):
        smoke.mono_case("causal", dtype, b=2, s=1024, causal=True,
                        dlse=False)
        smoke.mono_case("full", dtype, b=2, s=512, causal=False, dlse=False,
                        seed=1)
        smoke.mono_case("causal-dlse", dtype, b=2, s=1024, causal=True,
                        dlse=True, seed=2)
    for dtype in (bf16, fp32):
        smoke.mono_grid(dtype)
    mono_fwd, mono_bwd = smoke.mono_case("train", bf16, b=8, s=1024,
                                         causal=True, dlse=False, seed=3,
                                         timed=True)
    for dtype in (bf16, fp32):
        for name, shape in BLOCKED_CASES:
            smoke.blocked_case(name, dtype, **shape)
    # the shapes the main paths give the blocked kernels: the packed
    # phase's batch, the long16k rung, the long32k rung (flash_bwd_blocked
    # there too, beside the two passes the route picks)
    from determined_tpu_torch.models import gpt

    packed_ids = packed_batch(8, 1024, 3, gpt.small().vocab_size)[
        "segment_ids"]
    smoke.flash_case("packed-b8x1024", bf16, b=8, s_q=1024, s_k=1024,
                     segs=packed_ids, block=1024)
    packed_err = smoke.blocked_case("packed-b8x1024", bf16, timed=True, b=8,
                                    s_q=1024, s_k=1024, segs=packed_ids)
    long16 = smoke.long_timed(16384, ("flash_fwd", "flash_bwd_blocked"))
    long32 = smoke.long_timed(32768, ("flash_bwd_dq", "flash_bwd_dkv",
                                      "flash_bwd_blocked"))
    long_recs = {"flash_bwd_blocked": long16["flash_bwd_blocked"],
                 "flash_bwd_dq": long32["flash_bwd_dq"],
                 "flash_bwd_dkv": long32["flash_bwd_dkv"]}
    long_recs["flash_bwd_blocked"]["max_abs_err"] = max(
        long16["flash_bwd_blocked"]["max_abs_err"],
        packed_err["flash_bwd_blocked"])
    # the shapes phase context's ring hops give the kernels (the 32k
    # ring's diagonal hop is the S 16384 shape above, the 64k ring's the
    # S 32768 one)
    fused = ("flash_bwd_blocked",)
    two_pass = ("flash_bwd_dq", "flash_bwd_dkv")
    hop = dict(b=1, bwd=fused)
    smoke.hop_case("long16k-diag", s_q=8192, s_k=8192, causal=True, **hop)
    smoke.hop_case("long16k-full", s_q=8192, s_k=8192, causal=False, **hop)
    smoke.hop_case("zigzag-diag-half", s_q=4096, s_k=4096, causal=True, **hop)
    smoke.hop_case("zigzag-kv-after", s_q=4096, s_k=8192, causal=False,
                   **hop)
    smoke.hop_case("zigzag-kv-before", s_q=8192, s_k=4096, causal=False,
                   **hop)
    smoke.hop_case("long32k-full", s_q=16384, s_k=16384, causal=False, **hop)
    smoke.hop_case("long64k-full", b=1, s_q=32768, s_k=32768, causal=False,
                   bwd=two_pass)
    smoke.hop_case("window-kv-offset", b=8, s_q=512, s_k=512, causal=True,
                   kv_offset=512, window=256, bwd=fused,
                   segs=(packed_ids[:, 512:], packed_ids[:, :512]))
    for causal in (True, False):
        smoke.mono_case(f"ring-hop-{'diag' if causal else 'full'}", bf16,
                        b=8, s=512, causal=causal, dlse=True, seed=9,
                        timed=True)
    # the shapes phase tensor gives the kernels: 6 heads a rank at
    # tensor=2 (the headline mono pair; the packed window's flash_fwd and
    # fused blocked backward) and the ring's hops at context=2 x tensor=2
    smoke.mono_case("train-h6", bf16, b=8, s=1024, causal=True, dlse=False,
                    seed=3, timed=True, h=6)
    smoke.flash_case("packed-window256-h6", bf16, b=8, s_q=1024, s_k=1024,
                     window=256, segs=packed_ids, block=1024, h=6)
    smoke.blocked_case("packed-window256-h6", bf16, timed=True, b=8,
                       s_q=1024, s_k=1024, window=256, segs=packed_ids, h=6)
    for causal in (True, False):
        smoke.mono_case(f"ring-hop-{'diag' if causal else 'full'}-h6", bf16,
                        b=8, s=512, causal=causal, dlse=True, seed=9,
                        timed=True, h=6)
    # the shapes phase tensor's deterministic pair gives the kernels: the
    # headline at blocks 512 (flash_fwd, and the two passes with the
    # partials cap at 0), on one device (H 12) and a rank of tensor=2 (H 6)
    for heads in (12, 6):
        smoke.hop_case(f"headline-block512-h{heads}", b=8, s_q=1024,
                       s_k=1024, causal=True, bwd=two_pass, h=heads,
                       dlse=False, kind="train")
    # the shapes phase pipeline gives the mono pair: a microbatch of 2 rows
    # (M 4 of B 8), of 1 (pipeline=4, M 8), 6 heads a rank (× tensor=2)
    # and the ring's hops at S/2 (× context=2); phase experts runs the
    # headline shape above
    for name, rows, heads in (("pipeline-mb2", 2, 12), ("pipeline-mb1", 1, 12),
                              ("pipeline-mb2-h6", 2, 6)):
        smoke.mono_case(name, bf16, b=rows, s=1024, causal=True, dlse=False,
                        seed=3, h=heads, timed=True)
    for causal in (True, False):
        smoke.mono_case(f"pipeline-ring-hop-{'diag' if causal else 'full'}",
                        bf16, b=2, s=512, causal=causal, dlse=True, seed=9,
                        timed=True)

    # -- phases 4 to 10: the main paths ----------------------------------------------
    launches = smoke.engine_phase()
    smoke.greedy_phase()
    launches.update({n: v for n, v in smoke.train_phase().items()
                     if n in ("flash_fwd_mono", "flash_bwd_mono")})
    smoke.train_parity_phase()
    smoke.train_parity_phase("fused")
    smoke.train_parity_phase("two_pass")
    launches["flash_bwd_blocked"] = \
        smoke.train_long_phase()["flash_bwd_blocked"]
    launches.update({n: v for n, v in smoke.train_32k_phase().items()
                     if n in ("flash_bwd_dq", "flash_bwd_dkv")})
    smoke.train_packed_phase()

    # -- phases 11 to 26: checkpoints, the fixture, the rest of serving, the
    # -- rest of the training loop, the exec layer off and on the cluster, the
    # -- mesh, the context axis, the tensor axis, the elastic resize, the
    # -- experts, the pipeline stages, the generative zoo, the flash autotuner
    # -- and the integrations -----------------------------------------------------
    for phase in (smoke.checkpoint_phase, smoke.fixture_phase,
                  smoke.serving_http_phase, smoke.serving_parity_phase,
                  smoke.train_health_phase, smoke.exec_phase,
                  smoke.cluster_phase, smoke.mesh_phase,
                  smoke.context_phase, smoke.tensor_phase,
                  smoke.elastic_phase, smoke.experts_phase,
                  smoke.pipeline_phase, smoke.zoo_phase,
                  smoke.autotune_phase, smoke.integrations_phase):
        for name, count in phase().items():
            launches[name] += count

    kernels = []
    mono_shape = "B8 S1024 H12 D64 causal bf16"
    for name, source, replaces, rec, shape in (
        ("flash_fwd", FLASH_SOURCE, FLASH_REPLACES, flash[bf16],
         "B4 S512 H12 D64 causal packed bf16"),
        ("paged_attention", PAGED_SOURCE, PAGED_REPLACES, paged[bf16],
         "B8 R1 H12 D64 8 pages of 128 bf16"),
        ("flash_fwd_mono", MONO_FWD_SOURCE, MONO_FWD_REPLACES, mono_fwd,
         mono_shape),
        ("flash_bwd_mono", MONO_BWD_SOURCE, MONO_BWD_REPLACES, mono_bwd,
         mono_shape),
        *((name, source, replaces, long_recs[name], long_recs[name]["shape"])
          for name, source, replaces in (
              ("flash_bwd_blocked", BLOCKED_SOURCE, BLOCKED_REPLACES),
              ("flash_bwd_dq", DQ_SOURCE, DQ_REPLACES),
              ("flash_bwd_dkv", DKV_SOURCE, DKV_REPLACES))),
    ):
        assert launches[name] > 0, f"{name} never launched on its main path"
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": shape, "tflops": rec["tflops"],
            "bound_share": rec["bound_share"],
        })
    print(f"phase total: seconds={time.perf_counter() - t_start:.1f} "
          f"| card {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
