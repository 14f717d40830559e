#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing the run (non-zero exit, no result line) on any error:

1. device: name, count, power limit; TF32 off for float32 matmuls and
   convolutions;
2. build: compile the kernels (flash attention B1, its backward, stream_pack
   B2, decode attention B3, AdamW B4, cross-entropy B5, latent attention B6,
   expanded attention B7 and its backward, RMSNorm B8, rotary embeddings
   B9) for sm_90a, one nvcc for each source, all started together; print
   their ptxas register / shared-memory / spill reports;
3. kernel against its plain PyTorch version on the card over a sweep of
   dtypes, head dims (zamba2's 80 among them), GQA groups, lengths (ragged
   ones included), windows, soft-caps (with scores large enough for the cap
   to matter) and masks, each within atol + rtol*|ref|, launching every
   kernel of the library, at arctic-480b's GQA group 7 (56 over 8 heads,
   hd 128), and on the model layout at each shape, batch included, at
   which phases 11-14 call it (``family_shapes``: llava's prefill buckets
   and 2944 positions at GQA 7, seamless's bidirectional encoder and cross
   attention, Sq = 1 among them, zamba2's hd 80; after phase 14 the run
   fails if those phases called B1 at any other shape); model-layout
   inputs read through their strides (B=2, a head slice, a
   transposed (B,H,S,hd) storage, layouts that take one counted copy) and a
   captured call replayed on inputs changed in place; then times at
   phi4-mini's prefill buckets and S=2048, at arctic-480b's at S=512 and at
   the four families' shapes, in a CUDA graph and launched from Python,
   beside the plain version,
   ``F.scaled_dot_product_attention`` (a yardstick only: the port never
   calls it) and the card's bound; then at phase 20's prefill_32k shape, q
   (1, 32768, 24, 128) over 8 kv heads, causal, the longest prompt B1 runs:
   every head against the plain version, 3 q heads at a time, and timed;
3b. decode attention (B3) against its plain version on the card at every
   shape a decode path gives it, at both dtypes (``DECODE_CASES``: the
   served slots over 1024 positions, phase 5's float32 cache, decode_32k's
   share with a 0-d offset, which must give the bits of the same offset
   per row, seamless's and zamba2's cache form, the float32 smoke lanes,
   gemma2's window and soft-cap, starcoder2's GQA 12, three new tokens in
   two row tiles), each within atol + rtol*|ref| (bf16's atol scaled by
   each output row's rms, ``DECODE_TOL``); a fully masked row
   (the kernel writes 0); each case prints its plan (cluster, stages,
   chunk, rows, grid, shared memory) and how many of its clusters the card
   holds at once (``cudaOccupancyMaxActiveClusters``); then times at every
   served decode shape (``DECODE_TIMED``: phi4-mini's, decode_32k's,
   arctic's and llava's GQA 7, starcoder2's GQA 12, gemma2's windowed
   layer, seamless's and zamba2's cache forms), in a CUDA graph and
   launched from Python, beside the plain version,
   ``F.scaled_dot_product_attention`` over the cache with a boolean mask
   (a yardstick only: the port never calls it) and the bound;
3c. latent attention (B6) against its plain version on the card at every
   shape a DeepSeek-V2 path gives it (``LATENT_CASES``: the served decode,
   3 new tokens, the prefill buckets 64-512 at B = 1, decode_32k's share
   with a 0-d offset, which must give the bits of the same offset per row,
   the float32 smoke config's decode and prompt passes, the smoke widths
   at bf16, and the edges of the bf16 kernel's schedule: a chunk of an odd
   number of tiles, T off the 64-position tile, a visible end inside the
   second tile of a pair, a prompt of a pair and a lone tile), at B3's
   tolerance (``DECODE_TOL``), each run twice for the same bits; a fully
   masked row (the latents' mean, with and without a split); ptxas's
   registers and spills for each of the bf16 kernel's widths (a spill, or
   a note that ptxas serialized its wgmma, fails the run); each case prints
   its plan (grid, split, shared memory, kernels a call); then
   times at the served decode, decode_32k's share and prefill bucket 512,
   in a CUDA graph and launched from Python, beside the plain version, the
   fastest
   ``F.scaled_dot_product_attention`` call over q = [q_lat | q_rope], k =
   [ckv | krope], v = ckv in three layouts under each backend (a
   yardstick only; each refusal printed with its reasons) and the bound;
3d. expanded attention (B7), MLA's expanded form, forward (with each row's
   log-sum-exp) and backward (the five gradients), against its plain
   versions computed in float32 from the same inputs (``EXPANDED_CASES``:
   19h's shape, q (2, 4096, 128, 128 + 64) and v 128, a 16x16 device's
   train_4k share (16, 4096, 8, ·), 21b's prompt (2, 256, 128, ·), S 1, 63,
   65, 129, 512 and 1000, a q_pos that is not arange with rows that see no
   key, large scores (q and k drawn 4x as large, S 1000), the smoke widths
   at bf16 and at float32), q_nope and q_rope the split views of one query and k_rope the
   [:, :, 0] view the model makes, each within ``EXPANDED_GRAD_TOL`` (the
   output at B3's), every case twice with the same bits, no layout copy,
   every (dtype, direction) of the library launched (the wrappers'
   counts); ptxas's registers and
   spills for each of its ten kernels (a spill or a serialization note
   fails the run); then at 19h's shape and the train_4k share the forward
   and the forward + backward timed in a CUDA graph and from Python beside
   the plain version (from Python, a few batch rows and heads at a time so
   that its scores fit), the bound (the causal half's products at the bf16 peak: the
   forward's two, the backward's five) and the fastest
   ``F.scaled_dot_product_attention`` backend over q = [q_nope | q_rope],
   k = [k_nope | k_rope broadcast], v, ``is_causal`` (a yardstick only;
   each refusal printed);
3e. RMSNorm (B8: the forward with each row's rstd, the backward's dx and
   d(scale)) and rotary embeddings (B9, forward and with -sin, the
   backward) against their plain versions on the card at every shape the
   paths give them (``NORM_CASES``: 19c's 1024 x 3072 and 19h's 8192 x
   5120 rows, MLA's c_kv read in its 576-wide rows, the qk-norm's rows of
   128, the decode rows, the float32 widths of phases 5, 10, 15 and 19d,
   odd widths in both layouts, a base 16 and 2 bytes off, a row of one,
   rows wider than the backward's register plan; each case prints both
   plans and the backward's partial rows' bytes, and fails where the
   backward's plan assumed other blocks an SM than the card's occupancy
   gives, or more clusters than it holds at once; ``ROPE_CASES``: 19c's q
   and k, 19h's q_rope in 192-wide heads and
   k_rope in 576-wide rows where they lie, zamba2's hd 80, served decode
   at offsets, the smoke widths at float32, an odd half, a base 16 bytes
   off), B8 within the tolerances beside ``NORM_RTOL``, B9 bit for bit,
   every case twice with the same bits and no layout copy; ptxas's
   registers and spills; then at 19c's and 19h's shapes each timed in a
   CUDA graph and from Python beside the plain versions, the bytes bound
   and one PyTorch call each way (yardsticks only): ``F.rms_norm`` and
   ``aten._fused_rms_norm_backward`` on a bf16 weight;
4. serve: phi4-mini-3.8b at full width and depth, bf16, random weights made
   on the card from a seed, 8 requests through ``ServingEngine`` with
   CUDA-graph-sealed steps; checks the tokens and that prefill went
   through the kernel (the wrapper's count, and the profiler's count of
   flash kernels inside one prefill replay) with no layout copy, and that
   one profiled decode replay ran B3 (one kernel a call) once a layer;
5. the same code on the card and on the CPU (2 layers, float32, one set of
   weights): prefill logits within 1e-3 and identical greedy tokens;
6. stream_pack kernel against its plain PyTorch version on the card over
   lanes, shapes (the branchy cells', ragged ones, K or N off the 16-byte
   vector, K too deep for the float32 panel, the bf16 weight stream's, the
   wgmma kernel's ragged M, N, K and depth), dtypes, a shared or separate
   x, x 4 bytes off a 16-byte boundary, and x or w (or both) transposed
   where they lie, each within atol + rtol*|ref|; every kernel of the
   library (each ring tile and loader, each stream row tile, column tile
   and layout, each wgmma layout) and every layout through each ring's
   element-wise loads must be launched; ptxas's registers and spills of
   the wgmma kernels (a spill or a C75xx serialization note fails); then
   times at the
   four branchy cells' shapes and one bf16 shape, with the variant and tile
   each took, each call inside a CUDA graph and launched from Python,
   beside the plain version, one ``torch.matmul`` over the broadcast x (a
   yardstick only: the port never calls it) and the card's bound; then the
   MoE expert GEMMs of arctic-480b and deepseek-v2-236b at full width, bf16,
   at every capacity the served path gives them (M 2-64), against the
   plain version (computed a few lanes at a time), and at the decode
   capacity (4) and prefill bucket 64's (64) timed beside ``torch.bmm``
   and the weights' bytes; one of them runs twice and must give the same
   bits; then deepseek-v2-236b's six (product, layout) shapes at its
   training capacity (M 384, 160 lanes: the forward nn, dx nt and dw tn of
   gate/up and of down) on the wgmma kernel against the plain version, one
   twice for the same bits, each timed in a CUDA graph and from Python
   beside ``torch.bmm`` over the same views, the plain version and the
   bound (3.3 GB of bytes);
7. Nimble on the four branchy cells at full size, float32: plain eager
   PyTorch, ``EagerInterpreter``, ``Nimble`` on one stream, on Algorithm 1's
   streams (one CUDA graph over several CUDA streams) and packed onto
   stream_pack; checks each against eager, and each replay on another input
   and on other weights; prints the schedule's counts, the planned arena
   beside the graph pool's bytes, microseconds per call, the stream_pack
   kernels the profiler sees inside one packed replay (which must equal the
   packed mm groups) and their device time, and the streams it sees in one
   multi-stream replay; two packed replays must give the same bits; the
   ``JitPerOpEngine`` column (Fig. 7's TorchScript) within 1e-5 of eager;
8. serve: arctic-480b at full width and 2 of its 35 layers (about 55 GB of
   bf16 weights), random weights made on the card from a seed, 4 slots of
   1024 positions, buckets 64-512, 8 requests of 20-500 prompt tokens and 16
   new ones through ``ServingEngine`` with CUDA-graph-sealed steps; checks
   the tokens, the replays, the wrappers' counts, and that one decode
   replay and one prefill replay each ran 3 x n_layers B2 kernels (the
   expert GEMMs), the decode n_layers B3 and the prefill n_layers
   ``flash_fwd``; prints seal time,
   TTFT p50, decode tok/s, peak memory and the top device ops of each
   profiled replay with B2's share;
9. the same for deepseek-v2-236b (2 of 60 layers, MLA: no flash kernel and
   no B3; MLA's absorbed attention runs on B6 in every decode step and prompt
   pass: the wrapper counts 2 x n_layers launches a captured step, the
   profiled decode and bucket-512 prefill replays each run n_layers B6
   calls, their kernels counted with B6's share beside B2's, and no layout
   copy);
10. arctic-smoke and deepseek-v2-smoke on the card and on the CPU at
    float32, one set of weights (deepseek's MLA on B6's float32 kernel):
    identical greedy tokens, and the logits of a 48-token prompt pass and
    of the decode step after it within 1e-3;
11. llava-next-34b at full width and 4 of its 60 layers, bf16: served as
    phase 4 serves phi4-mini (text prompts), then one ``forward`` of 2880
    vision embeddings and 64 tokens (B1 at S = 2944, GQA 7);
12. seamless-m4t-medium at full width and depth, bf16: ``encode_memory``
    of 4 x 128 frames (B1 bidirectional), the teacher-forced ``forward``
    of 4 x 512 tokens, then 16 greedy steps of batch ``decode_step`` for 4
    sequences with the memory in the cache (cross attention on B1 with one
    query row, self attention on B3's cache form), eagerly and as a
    captured CUDA graph: the same tokens; a profiled decode replay runs B3
    once a decoder layer;
13. zamba2-2.7b at full width and depth, bf16: ``forward`` of 4 x 512
    tokens (the chunked SSD; the shared block's attention on B1 at hd 80,
    9 times), then the batch decode of phase 12 from an empty state (the
    shared block on B3 at hd 80, 9 times a replay);
14. xlstm-125m at full width and depth, bf16: the same as phase 13 (the
    chunked mLSTM, sLSTM at layers 3, 7 and 11; no attention);
15. the smoke configs of llava-next, seamless, zamba2 and xlstm on the card
    and on the CPU at float32, one set of weights: ``forward`` logits within
    ``FAMILY_FORWARD_TOL`` and identical greedy tokens (llava through
    ``ServingEngine``, the others by batch decode);
16. the control plane in process: an ``AsyncDispatcher`` over two lanes,
    phi4-mini-3.8b at full width and depth (class 0, a latency target) and
    deepseek-v2-236b at full width and 2 layers (class 1), bf16, one shared
    schedule cache; a burst of 16 mixed requests under per-engine steppers,
    under a pool of two, and once more profiled (the profiler must see
    exactly the ``flash_fwd`` and ``stream_pack`` kernels the lanes'
    replays imply, up to three bursts; that session gives the device's
    busy share of the burst; the MoE lane's B6 launches are counted).
    phi4-mini's tokens
    must equal the same engine's driven by ``run_until_drained``; the MoE
    lane's requests must complete with their token counts.  Then a third
    lane (phi4-mini smoke, float32, a schedule cache of one entry)
    registers while the two serve, capturing its CUDA graphs between their
    replays, and its first request re-seals an evicted bucket on its
    stepper: ``builds_on_thread`` must be 0 everywhere else.  The third
    lane's requests, served the same way on the CPU, give the same tokens;
17. the worker plane: ``stepping="workers"`` with one spawned worker on
    ``cuda:0`` building phi4-mini from ``ServingEngineSpec(smoke=False,
    dtype="bfloat16", seed=0)``; its tokens equal an in-process engine's
    built from the same spec; ``fork`` is refused (CUDA is initialised
    here); then the worker is SIGKILLed in the middle of a step: the
    requests in flight fail ``WorkerCrashed``, the queued ones replay on
    the respawned worker token-identically; prints spawn and respawn times;
18. journal and observability: a journaled run of that lane, stopped with
    work in flight, is recovered by a fresh dispatcher (the lane rebuilt
    from its journaled spec) and the unfinished requests replay
    token-identically; the recovered run's Chrome trace must validate, and
    a ``MetricsRegistry``'s Prometheus text must hold the dispatch, cache,
    worker-plane and tracer families;
19. training on the card: (a) B1's backward kernel (``flash_attention_bwd``)
    and the forward's log-sum-exp against their plain versions over both
    dtypes, every head dim, GQA 1/3/7, causal, windows, soft-caps, ragged
    and Sq != Skv lengths and fully masked rows (their dq must be 0),
    launching every kernel set of the library, then at phi4-mini's
    training shape: two calls bit-identical, no layout copy, the time in a
    CUDA graph and from Python beside the plain version, the bound and
    ``F.scaled_dot_product_attention``'s forward + backward (a yardstick
    only), each of its three kernels' device time (profiler), the dK/dV
    kernel with one CTA per (q head, key tile) instead, and each kernel's
    registers and spills from ptxas; (b) B2's two backward products through its autograd Function
    at the smoke experts' shapes, a shared x and a full deepseek-v2 expert
    shape (160 lanes, K 5120, N 1536) at M 64 (the stream) and at the
    training capacity M 384 (the wgmma kernel), w^T and x^T read where
    they lie (no layout copy, here or in 19d), timed there beside two
    ``torch.bmm``; (f) B4, the AdamW update (a sum of squares a leaf, a
    finish, an update a leaf), against its plain version at odd leaf sizes
    and phi4-mini's largest two, both dtypes, every clip mode, lr a float
    and a device tensor, a base off 16 bytes, three steps a case
    (``ADAMW_CASES``, the tolerances beside them), then timed over
    phi4-mini's 291 leaves in a CUDA graph beside the plain version, the
    bound and ``torch._foreach_norm`` + ``torch._fused_adamw_`` (a
    yardstick only); (g) B5, the loss on a vocabulary shard (a partials
    pass and a backward), against its plain version at every shape the
    training paths give it (19c's 2 x 512 x 200192 logits: phi4-mini's
    vocabulary padded to 200192 columns, 21d's xlstm-125m, 19d's smoke
    configs), one device's shard at phi4-mini's train_4k on 16x16 (65536 x
    12512 from column 62560), a width off the 4-column
    group, the last of an uneven split, a base off 16 bytes and -inf
    columns that fill whole groups, each with
    labels -1, 0, the shard's last column, outside the shard and a fully
    masked sequence (tolerances beside ``CE_GRAD_RTOL``), then timed at
    19c's shape, the shard and xlstm's in a CUDA graph and from Python
    beside the plain version, the bound and ``F.cross_entropy``'s forward
    + backward (a yardstick only); (c) phi4-mini-3.8b at full width and depth, bf16,
    AdamW on B4 with the cosine schedule, batch 2 x 512 from
    ``SyntheticLM``: 3 eager steps against 3 replays of the step sealed as
    one CUDA graph from the same state, 30 replays in all (the loss must
    fall), ms per step eager and replayed (Fig. 8's quantity), B1's layout
    copies (must be 0), B4's and B5's kernels eager and by the seal (the
    seal's warm-up counted apart from its capture), the profiler's count of
    B1's forward and backward kernels (32 of each), of B4's (291 sums, a
    finish, 291 updates) and of B5's (a partials pass and a backward) in
    one replay with each one's share of its time, and a checkpoint
    restored into a fresh model giving the next replay's loss bit for bit;
    (d) the phi4-mini, arctic and deepseek-v2 smoke configs at float32: one
    sealed step on the card (B4's kernels counted; deepseek's MLA on B7's
    float32 kernels, forward and backward) against the CPU's; (h)
    deepseek-v2-236b at full width (d 5120, 128 heads, q_lora 1536, kv_lora
    512, 160 experts) cut to 1 of its 60 layers, bf16, AdamW on B4, the loss
    on B5, the expert GEMMs and their backward on B2, MLA's expanded form on
    B7, batch 2 x 4096 from ``SyntheticLM`` (train_4k's sequence length): 3
    eager steps against 3 replays of the step sealed as one CUDA graph from
    the same state (losses, grad norms and parameters bit for bit), 20
    replays in all (the loss must fall), ms per step eager and replayed,
    tok/s, seal s, peak memory, no layout copy, and one profiled replay's
    kernels: B7's five (forward, pre-pass, dK/dV, dQ, rope reduce) beside
    B2's, B4's and B5's shares, B2's kernels by variant (its nine products
    a layer must all be the wgmma kernel's); (e) Nimble over the
    gradients of the four branchy cells at full size, eager torch.func
    against single-stream, multi-stream and packed replays, µs per call;
20. the launch layer: (a) the dry run (``repro_torch.launch.dryrun``) of
    every arch x applicable input shape x production mesh (16x16 and
    2x16x16) on the meta device, in subprocesses on the host's CPU while
    the card draws (b)'s and (c)'s model, all ended before (b) and (c) time
    anything: one line a case with its argument bytes per device, its
    global FLOPs and its partitioned step per device (a fake process group
    of the mesh's size): FLOPs, bytes accessed, temp and output bytes
    (``fits``: argument + temp + output within 80 GB) and collective bytes;
    any failure, and any case that did not partition, fails the run; the
    MoE cases (deepseek-v2 and arctic at train_4k and prefill_32k, each
    device routing its own tokens) printed again together: temp, ``fits``
    and collective bytes by kind, under the host's torch;
    (b) decode_32k at one device's share: phi4-mini-3.8b at full width and
    depth, bf16, 8 sequences over a synchronized (``per_slot=False``)
    cache of 32768 positions filled from a seed: its logits equal the
    per-slot step's on the same state, then 8 greedy steps eagerly and as
    replays of one captured step give the same tokens; ms per replay, the
    top device ops of one replay (B3 once a layer), the peak memory; (c)
    prefill_32k at B = 1
    (a cut of the per-device share of 2): ``forward`` of 32768 tokens, B1
    launched once a layer at the shape phase 3 checked, finite logits, the
    time and the peak memory;
21. sharded execution on one card: a process group of one (NCCL, rank 0 of
    1) and ``make_host_mesh(model_axis=1)``, a (1, 1) mesh where every
    placement is Replicate: (a) phase 19c's phi4-mini-3.8b step with the
    parameters and AdamW state as DTensors (``shard_model``), 3 eager
    steps (losses and grad norms bit-identical to 19c's eager steps, B1
    forward and backward launched through ``local_map`` as often, 0
    collectives under ``CommDebugMode``), then the step sealed as one CUDA
    graph and replayed from the same state: losses, grad norms and the
    parameters after 3 replays bit-identical to 19c's replays; ms per step
    eager (DTensor's dispatch on the host) and replayed, each beside 19c's;
    (b) deepseek-v2-236b at full width and 2 layers, bf16: a sharded
    ``forward`` of a 2 x 256 prompt, logits bit-identical to the unsharded
    forward's, B2 launched through ``local_map`` 3 times a layer and B7
    (MLA's expanded form) once a layer; (c) the
    dry run's memory count (a fake (1, 1) mesh, meta tensors) at 19c's
    step: its predicted peak (argument + temp + output bytes) against
    19c's measured eager peak less what earlier phases left allocated,
    the ratio within ``MEMORY_BAND``; (d) xlstm-125m at full width and
    depth, bf16, 3 eager train steps and 3 replays of the sealed step with
    DTensor parameters (the mLSTM and sLSTM on local shards): losses, grad
    norms and parameters bit-identical to the same steps unsharded; (e)
    zamba2-2.7b at full width and depth: a sharded ``forward`` of 4 x 512
    tokens (Mamba2's conv and scan on local shards), logits bit-identical
    to the unsharded forward's, B1 launched through ``local_map`` once per
    shared attention block (9); (f) phase 19h's DeepSeek-V2 step (full
    width, 1 of 60 layers, 2 x 4096 tokens) with the parameters, AdamW
    state and batch as DTensors, the MoE routing each device's tokens: 3
    eager steps and 3 replays of the sealed step, losses, grad norms and
    parameters bit-identical to 19h's (kept on the host), every B2 launch
    from a call through ``local_map``, B7, B4 and B5 launched as in 19h, 0
    collectives; ms per step eager and replayed beside 19h's.
    Collectives across cards are checked on the CPU only (gloo, tier-1):
    NCCL refuses two ranks on one card;
22. long_500k on the card (batch 1, a cache of 524288 positions, the
    long-context rules' cache sharded over positions): (a) B3's partials
    form at zamba2-2.7b's cache form (32 heads of 80) and gemma2-27b's
    global and local (window 4096) layers in the deferred form (32 over 16
    heads of 128, cap 50), the cache split into 1, 2, 3 (uneven), 4 and 8
    shards as strided views, kv_valid inside a shard, on a boundary and
    before whole shards: each shard's (out, lse) against its plain version,
    the shards combined (``ops.combine`` over their stack) against the
    plain version and the whole-cache B3, all at B3's tolerance; then the
    whole B3, the partials of 1, 2 and 8 shards plus the combine, the plain
    version and ``F.scaled_dot_product_attention`` with a boolean mask timed
    in a CUDA graph beside the bytes bound; (b) zamba2-2.7b at full width
    and depth and (b') gemma2-27b at full width and 2 layers (one local,
    one global), bf16, the cache filled from a seed, pos 17 before its end:
    16 greedy steps eagerly and as replays of one captured step, then the
    same storage wrapped as DTensors on phase 21's (1, 1) mesh, the cache
    ``Shard`` over its positions, so that attention takes the partials
    path: the same tokens, logits within B3's tolerance (bit-identical
    said), ms per replay of both beside the step's bytes bound, the peak
    memory, one B3 kernel an attention layer in a profiled replay of each;
    (c) two processes on the one card over gloo, a (2,) mesh over
    positions, each holding its half of zamba2's cache:
    ``layers._decode_attention`` within B3's tolerance of the whole-cache
    B3 and of the plain version, the two ranks' outputs equal;
23. DeepSeek-V2 at decode_32k's per-device share: deepseek-v2-236b at full
    width and 2 layers, bf16, phase 9's weights' seed, 8 sequences over a
    synchronized latent cache of 32768 positions filled from a seed, all
    128 heads: 8 greedy steps eagerly and as replays of one captured step
    give the same tokens and logits; ms a replay, its kernel time, B6's
    kernels and share beside B2's, the peak memory.

Each phase prints its times (CUDA events, graph replays), the kernels of
one profiled call, and the wrappers' counts; each forward and each decode
must launch the flash kernel exactly as often as the model has attention
over a full sequence or a memory.

Each profiled graph replay has its outputs poisoned before it and must
give them back right, so a replay that ran nothing cannot pass as a
profiler that saw nothing.

B3's launches are counted over each decode path (``B3_BY_PATH``: phases
4, 5, 8, 10-13, 15-18, 20b and 22b, each of which must launch it; its
partials form's over 22b's sharded paths, ``B3_PARTIALS_BY_PATH``), every B3
kernel (dtype, head dim, rows) the paths ran must be one phase 3b checked,
and no phase after 3b may make a layout copy for it; the profiled decode
replays held and B3's kernels in them are counted (``B3_REPLAYS``).  B2's
launches are counted by path and variant (``B2_VARIANTS``), beside its
layout copies over the run.  B4's
and B5's launches are counted over each training path (``B4_BY_PATH``,
``B5_BY_PATH``: 19c, 19d, 19h, 21a, 21f, 21d, each of which must launch
them), and
the profiled training replay's B1-backward, B4 and B5 kernels over the
wrapper's counts for the capture (``B1BWD_REPLAYS``, ``B4_REPLAYS``,
``B5_REPLAYS``): the kernels line prints these measured counts.  B6's
launches are counted over each path that serves DeepSeek-V2
(``B6_BY_PATH``: phases 9, 10, 16 and 23, each of which must launch it, none
after phase 3c with a layout copy), and its kernels in the profiled replays
of phases 9 and 23 over their calls (``B6_REPLAYS``).  B7's calls, forward
and backward, are counted over each path that runs MLA's expanded form
(``B7_BY_PATH``: 19d, 19h, 21b and 21f, each of which must launch it, none
after phase 3d with a layout copy), and its kernels in 19h's profiled
replay over the capture's calls (``B7_REPLAYS``).  B8's and B9's calls
are counted over the paths of phases 4, 5, 8-11, 13, 15-21 and 23
(``NORM_ROPE_BY_PATH``; those of ``NORM_ROPE_PATHS`` must launch both),
and every profiled replay of phases 4, 8, 9, 11, 19c and 19h must run
them as often as its model's layers give (``check_norm_rope``: a norm
and its backward's two kernels, a rotation and its backward, counted in
``NORM_ROPE_REPLAYS``).  19c and 19h also profile one eager step with the
chains' functions in ranges and print its element-wise kernels by chain
beside each chain's bytes bound (``chain_breakdown``).

The line before the last is the per-kernel JSON record; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent

# (atol, rtol): the kernel passes where |got - ref| <= atol + rtol * |ref|.
# float32 differs from its plain version only by summation order; bf16 also
# by the rounding of p and of the output (one bf16 ulp is 2**-8 relative)
TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-2, 1e-2)}
# soft-cap cases scale q up so that scores reach about +-20 and the cap
# bends them; at unit scale a cap of 50 would move the output by ~1e-3
CAP_Q_SCALE = 8.0
# the served phases' prefill buckets and decode slots, and the lengths
# phase 3 times B1 at
PREFILL_BUCKETS = (64, 128, 256, 512)
SERVE_SLOTS = 4
TIMED_LENGTHS = PREFILL_BUCKETS + (2048,)


def ratio(got, ref, atol: float, rtol: float) -> float:
    """Largest ``|got - ref| / (atol + rtol * |ref|)``: within tolerance at <= 1."""
    ref = ref.float()
    return ((got.float() - ref).abs() / (atol + rtol * ref.abs())).max().item()


def tol_ratio(got, ref, dname: str) -> float:
    """:func:`ratio` at flash attention's tolerance for ``dname``."""
    return ratio(got, ref, *TOL[dname])


def bound(flops: float, nbytes: float, dname: str) -> tuple[float, str]:
    """The least time the card could take for ``flops`` operations in
    ``dname`` and ``nbytes`` moved, in ms, and which of the two bounds it,
    at the H100's peaks (``repro_torch.launch.mesh``: NVIDIA's data sheet)."""
    from repro_torch.launch.mesh import PEAK_BYTES, PEAK_FLOPS

    t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# (phase, host clock) at each phase's header, for the time each phase took
PHASE_STARTS: list[tuple[str, float]] = []


def say(msg: str) -> None:
    if msg.startswith("== phase "):
        PHASE_STARTS.append((msg[len("== phase "):].split(":")[0], time.perf_counter()))
    print(msg, flush=True)


def phase_seconds(end: float) -> str:
    """Each phase's seconds, from its header to the next one's (the last's
    to ``end``)."""
    marks = PHASE_STARTS + [("", end)]
    return ", ".join(f"{name} {t1 - t0:.1f}" for (name, t0), (_, t1) in zip(marks, marks[1:]))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back launches, on CUDA
    events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def capture(graph):
    """``torch.cuda.graph(graph)`` in its default (global) error mode, with
    Python's cyclic garbage collector held off (``core.capture.capture_graph``):
    an automatic collection inside the capture may free a cycle that holds
    another CUDA graph (an earlier phase's engine and its sealed steps), and
    destroying a graph while a stream captures is refused and ends the
    capture in an error."""
    from repro_torch.core.capture import capture_graph

    return capture_graph(graph, capture_error_mode="global")


def graph_ms(fn, reps: int = 20, iters: int = 50) -> float:
    """Mean time of one call of ``fn`` inside a CUDA graph of ``reps``
    back-to-back calls, replayed ``iters`` times: the device's time for the
    call without the host's cost of launching it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with capture(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, iters) / reps


def phase_device():
    import torch

    say("== phase 1: device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA card")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    say(f"device: {name} | count {count} | torch {torch.__version__} cuda {torch.version.cuda}")
    say(f"nvidia-smi: {nvidia_smi()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return name, count


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    from repro_torch.kernels.adamw import kernel as adamw
    from repro_torch.kernels.cross_entropy import kernel as ce
    from repro_torch.kernels.decode_attention import kernel as decode
    from repro_torch.kernels.expanded_attention import backward as expanded_bwd
    from repro_torch.kernels.expanded_attention import kernel as expanded
    from repro_torch.kernels.flash_attention import backward as flash_bwd
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.latent_attention import kernel as latent
    from repro_torch.kernels.rms_norm import kernel as rms
    from repro_torch.kernels.rotary import kernel as rotary
    from repro_torch.kernels.stream_pack import kernel as pack

    say("== phase 2: build")
    sources = [flash.SOURCE, flash_bwd.SOURCE, pack.SOURCE, decode.SOURCE, adamw.SOURCE,
               ce.SOURCE, latent.SOURCE, expanded.SOURCE, expanded_bwd.SOURCE, rms.SOURCE,
               rotary.SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:      # one nvcc per source
        list(pool.map(build.build, sources))
    say(f"built {', '.join(build.library_path(s).name for s in sources)} in "
        f"{time.perf_counter() - t0:.1f}s")
    for source in sources:
        build.load(source)
        say(f"  {source.name}:")
        for line in build.build_log(source).splitlines():
            if "ptxas" in line or "spill" in line:
                say(f"    {line.strip()}")


def _qkv(BH_kv, group, Sq, Skv, hd, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((BH_kv * group, Sq, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((BH_kv, Skv, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((BH_kv, Skv, hd), generator=g, device="cuda").to(dtype)
    return q, k, v


# phase 3's (group, window, softcap, causal) combinations, run at every
# dtype, head dim and length
FLASH_COMBOS = [(1, 0, 0.0, True), (3, 0, 50.0, True), (4, 16, 0.0, True),
                (3, 100, 50.0, True), (1, 0, 0.0, False), (4, 16, 50.0, False),
                (3, 100, 0.0, False)]


def flash_cases() -> list[tuple[str, int, int, int, int, int, int, float, bool]]:
    """Phase 3's (dtype, hd, kv heads, group, Sq, Skv, window, softcap,
    causal) cases: 172 with 2 kv heads (every head dim, zamba2-2.7b's 80
    among them), then phi4-mini's 8 kv heads x group 3 at S=2048 for every
    head dim, a grid that fills the card (the 172 take the split tile at
    S=200 and 1024, the single one at S=64)."""
    cases = []
    for dname in ("float32", "bfloat16"):
        for hd in (32, 64, 80, 128):
            for S in (64, 200, 1024):
                for group, window, cap, causal in FLASH_COMBOS:
                    cases.append((dname, hd, 2, group, S, S, window, cap, causal))
        for causal in (True, False):                 # Sq != Skv
            cases.append((dname, 128, 2, 3, 64, 256, 0, 0.0, causal))
    for hd in (32, 64, 80, 128):
        cases.append(("bfloat16", hd, 8, 3, 2048, 2048, 0, 0.0, True))
        cases.append(("bfloat16", hd, 8, 3, 2048, 2000, 300, 50.0, False))
    return cases


def gqa7_cases() -> list[tuple[str, int, int, int, int, int, int, float, bool]]:
    """Phase 3's cases at arctic-480b's attention: 56 query heads over 8 kv
    heads (GQA group 7), hd 128, causal, at the smallest and largest prefill
    bucket, in both dtypes (same fields as :func:`flash_cases`)."""
    return [(dname, 128, 8, 7, S, S, 0, 0.0, True)
            for dname in ("bfloat16", "float32") for S in (64, 512)]


# the paths of phases 11-14 that launch B1; llava-next-34b's forward puts a
# prompt of VLM_PROMPT tokens after its vision embeddings
FAMILY_ARCHS = ("llava-next-34b", "seamless-m4t-medium", "zamba2-2.7b")
VLM_PROMPT = 64


def path_attention_shapes(cfg, batch: int, length: int, prompt: int,
                          buckets) -> list[tuple[str, int, int, int, int, int, int, bool]]:
    """B1's calls on the path of phases 11-14 for ``cfg``, as (label, B, q
    heads, kv heads, Sq, Skv, hd, causal): llava served (a one-request
    prefill at each of ``buckets``; its decode attention is plain) and a
    forward of its vision embeddings and ``prompt`` tokens; seamless's
    encoder over ``length // audio_frames_ratio`` frames, its decoder's self
    and cross attention in a forward of ``batch`` x ``length`` tokens, and
    the cross attention of a decode step (one query row); zamba2's shared
    block in a forward of ``batch`` x ``length`` tokens (its decode
    attention is plain); a dense model's layers in a forward of ``batch``
    x ``length`` tokens (phase 20's prefill_32k; its decode attention is
    plain); none for xLSTM."""
    H, KV, hd, name = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.name
    if cfg.family == "vlm":
        S = cfg.vision_tokens + prompt
        return [(f"{name} prefill {b}", 1, H, KV, b, b, hd, True) for b in buckets] + [
            (f"{name} vision prompt", 1, H, KV, S, S, hd, True)]
    if cfg.family == "audio":
        T = length // cfg.audio_frames_ratio
        return [(f"{name} encoder", batch, H, KV, T, T, hd, False),
                (f"{name} decoder prompt", batch, H, KV, length, length, hd, True),
                (f"{name} cross attention", batch, H, KV, length, T, hd, False),
                (f"{name} cross attention, decode", batch, H, KV, 1, T, hd, False)]
    if cfg.family == "hybrid":
        return [(f"{name} shared block", batch, H, KV, length, length, hd, True)]
    if cfg.family == "dense":
        return [(f"{name} prompt", batch, H, KV, length, length, hd, True)]
    return []


def family_shapes() -> list[tuple[str, int, int, int, int, int, int, bool]]:
    """:func:`path_attention_shapes` of the full configs at the sizes phases
    11-14 drive them."""
    import repro_torch.configs as C

    return [shape for arch in FAMILY_ARCHS for shape in path_attention_shapes(
        C.get(arch), DECODE_BATCH, FORWARD_LEN, VLM_PROMPT, PREFILL_BUCKETS)]


def family_cases() -> list[tuple[str, int, int, int, int, int, int, bool]]:
    """Phase 3's model-layout cases at :func:`family_shapes`, in both
    dtypes, as (dtype, B, hd, kv heads, group, Sq, Skv, causal)."""
    return [(dname, B, hd, kv, q // kv, Sq, Skv, causal)
            for dname in ("bfloat16", "float32")
            for _, B, q, kv, Sq, Skv, hd, causal in family_shapes()]


# phase 20: the decode_32k and prefill_32k shapes' length, on phi4-mini
LONG_ARCH, LONG_PROMPT = "phi4-mini-3.8b", 32768


def long_prompt_shapes() -> list[tuple[str, int, int, int, int, int, int, bool]]:
    """B1's calls in phase 20's prefill_32k forward (phi4-mini at B = 1,
    32768 tokens), as :func:`path_attention_shapes` gives them."""
    import repro_torch.configs as C

    return path_attention_shapes(C.get(LONG_ARCH), 1, LONG_PROMPT, 0, ())


def long_prompt_cases() -> list[tuple[str, int, int, int, int, int, int, bool]]:
    """Phase 3's case at :func:`long_prompt_shapes`, in bf16 (the path's
    dtype), with :func:`family_cases`' fields."""
    return [("bfloat16", B, hd, kv, q // kv, Sq, Skv, causal)
            for _, B, q, kv, Sq, Skv, hd, causal in long_prompt_shapes()]


def _flash_tile(q, k, v) -> str:
    from repro_torch.kernels.flash_attention import kernel

    launch = kernel.launch_for(q, k, v)
    return (f"tile {launch.rows} rows x {launch.keys} keys, {launch.warpgroups} consumer "
            f"warpgroup(s), {launch.threads} threads, grid {launch.grid}, smem "
            f"{launch.smem_bytes} B, TMA boxes q {launch.q_box} kv {launch.kv_box}")


def _bshd_qkv(B, kv_heads, group, Sq, Skv, hd, dtype, seed):
    """Contiguous model-layout q (B, Sq, heads, hd) and k, v (B, Skv,
    kv_heads, hd), as the models' projections give them."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((B, S, n, hd), generator=g, device="cuda").to(dtype)
            for S, n in ((Sq, kv_heads * group), (Skv, kv_heads), (Skv, kv_heads))]


def _ref_bshd(q, k, v, group, **kw):
    """flash_attention_ref on model-layout (B, S, H, hd) tensors."""
    from repro_torch.kernels.flash_attention import flash_attention_ref

    B, Sq, NH, hd = q.shape
    flat = [t.transpose(1, 2).reshape(B * t.shape[2], t.shape[1], hd) for t in (q, k, v)]
    return flash_attention_ref(*flat, group=group, **kw).reshape(B, NH, Sq, hd).transpose(1, 2)


def phase_kernel() -> dict:
    import torch

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.flash_attention import kernel

    say("== phase 3: flash_attention kernel vs plain version (tolerance "
        "|err| <= atol + rtol*|ref|: f32 1e-4 + 0 for summation order; bf16 "
        f"1e-2 + 1e-2*|ref| for bf16 rounding of p and output; soft-cap cases "
        f"scale q by {CAP_Q_SCALE:g} so the cap bends the scores)")
    # (batch, case): B1 on (BH, S, hd) for batch None, else on the model
    # layout (B, S, heads, hd) at the batch the family paths give it
    cases = [(None, c) for c in flash_cases() + gqa7_cases()] + [
        (B, (dname, hd, kv, group, Sq, Skv, 0, 0.0, causal))
        for dname, B, hd, kv, group, Sq, Skv, causal in family_cases()]
    worst, reached = 0.0, {}
    for i, (B, (dname, hd, kv_heads, group, Sq, Skv, window, cap, causal)) in enumerate(cases):
        dtype = getattr(torch, dname)
        if B is None:
            q, k, v = _qkv(kv_heads, group, Sq, Skv, hd, dtype, seed=i)
            run, plain = flash_attention, flash_attention_ref
        else:
            q, k, v = _bshd_qkv(B, kv_heads, group, Sq, Skv, hd, dtype, seed=i)
            run, plain = kernel.attention, _ref_bshd
        if cap:
            q = q * CAP_Q_SCALE                      # a power of 2: exact in bf16
        kw = dict(group=group, softcap=cap, causal=causal, window=window)
        launch = kernel.launch_for(q, k, v)
        got = run(q, k, v, **kw)
        ref = plain(q, k, v, **kw)
        torch.cuda.synchronize()
        reached[launch.instance] = reached.get(launch.instance, 0) + 1
        err = (got.float() - ref.float()).abs().max().item()
        ratio = tol_ratio(got, ref, dname)
        ok = math.isfinite(err) and ratio <= 1.0
        note = ""
        if cap:
            # the cap must matter here, or this case cannot catch a kernel
            # that ignores it
            uncapped = plain(q, k, v, **{**kw, "softcap": 0.0})
            moved = (uncapped.float() - ref.float()).abs().max().item()
            note = f" | cap moves the output by {moved:.3e}"
            if not moved >= 10 * TOL[dname][0]:
                fail(f"soft-cap {cap} moves the output by only {moved}: the case is blind to it")
        say(f"  {dname:8s} B={B or 1} hd={hd:3d} heads={kv_heads * group:2d}/{kv_heads} "
            f"Sq={Sq:4d} Skv={Skv:4d} window={window:3d} softcap={cap:4.0f} "
            f"causal={int(causal)} wg={launch.warpgroups}: max_abs_err {err:.3e} ({ratio:.2f} "
            f"of tolerance) {'ok' if ok else 'FAIL'}{note}")
        if not ok:
            fail(f"kernel disagrees with its plain version: {ratio:.3f} of tolerance {TOL[dname]}")
        worst = max(worst, ratio)
    say(f"  {len(cases)} cases within tolerance (worst at {worst:.2f} of its tolerance); "
        "cases by kernel (dtype, hd, consumer warpgroups, keys): "
        + ", ".join(f"{d} {hd} {w}x{kk} {n}" for (d, hd, w, kk), n in sorted(reached.items())))
    missing = set(kernel.INSTANCES) - set(reached)
    if missing:
        fail(f"phase 3 never launched the flash kernels {sorted(missing)}")
    flash_layouts()
    record = flash_timing(describe=_flash_tile)
    record["arctic_prefill"] = flash_timing(
        describe=_flash_tile, q_heads=56, lengths=(512,), model="arctic-480b")
    say("-- timing at the family paths' shapes (bf16; batch x heads as heads, which "
        "gives the same grid and tile)")
    record["family_shapes"] = {
        label: flash_time(B * q, B * kv, Sq, Skv, hd, causal, label, describe=_flash_tile)
        for label, B, q, kv, Sq, Skv, hd, causal in family_shapes()}
    record["long_prompt"] = flash_long_prompt()
    return record


def flash_long_prompt() -> dict:
    """B1 at phase 20's prefill_32k shape, the longest prompt it runs: q
    (1, 32768, 24, 128), kv 8 heads, bf16, causal, on the model layout.
    Held against the plain version one kv head's 3 q heads at a time (its
    float32 scores are 4.3 GB a head), every row; then timed in a CUDA graph
    beside ``F.scaled_dot_product_attention`` (a yardstick: the port never
    calls it) and the bound; the plain version's time is that of its eight
    calls, launched from Python after one untimed call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel

    (label, B, H, KV, Sq, Skv, hd, causal), = long_prompt_shapes()
    G = H // KV
    say(f"-- {label}: q ({B},{Sq},{H},{hd}) kv {KV} heads, bf16, causal; the plain version "
        f"{G} q heads (one kv head) at a time")
    q, k, v = _bshd_qkv(B, KV, G, Sq, Skv, hd, torch.bfloat16, seed=2024)
    kw = dict(group=G, causal=causal)
    before = kernel.layout_copies
    got = kernel.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    worst, err, plain_ms = 0.0, 0.0, 0.0
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def plain(j):
        heads = slice(j * G, (j + 1) * G)
        start.record()
        ref = _ref_bshd(q[:, :, heads], k[:, :, j:j + 1], v[:, :, j:j + 1], G, causal=causal)
        stop.record()
        stop.synchronize()
        return ref, start.elapsed_time(stop)

    # an untimed first call, as the other plain versions get warm-up calls:
    # the first one also pays for growing the allocator's pool
    warmup_ms = plain(0)[1]
    for j in range(KV):
        heads = slice(j * G, (j + 1) * G)
        ref, chunk_ms = plain(j)
        plain_ms += chunk_ms
        part = got[:, :, heads]
        worst = max(worst, tol_ratio(part, ref, "bfloat16"))
        err = max(err, (part.float() - ref.float()).abs().max().item())
        del ref
    if not (math.isfinite(err) and worst <= 1.0):
        fail(f"B1 disagrees at {label}: {worst:.3f} of tolerance, max_abs_err {err}")
    if kernel.layout_copies != before:
        fail(f"B1 took {kernel.layout_copies - before} layout copies at {label}")
    # the library on (B, H, S, hd) with each kv head repeated for its q
    # heads, on its flash or memory-efficient kernel: the math one would
    # hold 103 GB of scores
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4 = q.transpose(1, 2).contiguous()
    k4, v4 = (t.transpose(1, 2).repeat_interleave(G, dim=1).contiguous() for t in (k, v))

    def library():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
            return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    ms = graph_ms(lambda: kernel.attention(q, k, v, **kw), reps=2, iters=3)
    library_ms = graph_ms(library, reps=2, iters=3)
    eager_ms = time_ms(lambda: kernel.attention(q, k, v, **kw), 3, warmup=1)
    pairs = Sq * (Sq + 1) // 2                       # causal, Sq == Skv
    bound_ms, bound_by = bound(4.0 * hd * H * B * pairs,
                               (2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
                               "bfloat16")
    say(f"  {H} heads within tolerance (worst {worst:.2f} of it), max_abs_err {err:.3e}, "
        f"0 layout copies | graph kernel_ms {ms:.5f} library_ms {library_ms:.5f} | eager "
        f"kernel_ms {eager_ms:.5f} | plain_ms {plain_ms:.5f} ({KV} calls of {G} heads; the "
        f"untimed first call {warmup_ms:.5f}) | "
        f"bound_ms {bound_ms:.5f} ({bound_by}) | kernel at {bound_ms / ms:.1%} of bound, "
        f"{library_ms / ms:.3f}x the library's speed | {_flash_tile(q, k, v)}")
    return dict(shape=[B, Sq, H, KV, hd], max_abs_err=err, ms=ms, eager_ms=eager_ms,
                plain_ms=plain_ms, plain_first_call_ms=warmup_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def flash_layouts() -> None:
    """Model-layout inputs read through their strides, held against the
    plain version: each must take exactly the expected number of counted
    layout copies.  Then a call captured in a CUDA graph, replayed after
    new values were written into its inputs in place."""
    import torch

    from repro_torch.kernels.flash_attention import kernel, mha_flash

    say("-- model layout (B, S, H, hd) through strides: 24 q heads over 8 kv heads")
    B, S, NH, NKV = 2, 200, 24, 8
    g = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def misaligned_rows(t):
        # the same values with a sequence stride 4 elements past the packed one
        B_, S_, H_, hd_ = t.shape
        row = H_ * hd_ + 4
        store = torch.zeros(B_ * S_ * row, dtype=t.dtype, device=t.device)
        view = store.as_strided(t.shape, (S_ * row, row, hd_, 1))
        view.copy_(t)
        return view

    def offset_base(t):
        # the same values one element past a 16-byte boundary
        store = torch.zeros(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = store[1:].view(t.shape)
        view.copy_(t)
        return view

    layouts = {
        "contiguous (B,S,H,hd)": (lambda t: t, 0),
        "q a head slice of a wider tensor":
            (lambda t: torch.cat([t[:, :, :4], t, t[:, :, :4]], dim=2)[:, :, 4:4 + t.shape[2]], 0),
        "(B,H,S,hd) storage as a transposed view":
            (lambda t: t.transpose(1, 2).contiguous().transpose(1, 2), 0),
        "sequence stride 8 bytes off 16 (bf16: one counted copy)": (misaligned_rows, 1),
        "base pointer off 16 bytes (bf16: one counted copy)": (offset_base, 1),
    }
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        for hd in (64, 128):
            q0, k, v = randn(B, S, NH, hd, dtype=dtype), randn(B, S, NKV, hd, dtype=dtype), \
                randn(B, S, NKV, hd, dtype=dtype)
            for name, (make, copies) in layouts.items():
                q = make(q0)
                if dname == "float32" and copies:
                    copies = 0          # the float32 kernel reads element-wise
                before = kernel.layout_copies
                got = mha_flash(q, k, v, causal=True)
                made = kernel.layout_copies - before
                ref = _ref_bshd(q0, k, v, NH // NKV, causal=True)
                torch.cuda.synchronize()
                r = tol_ratio(got, ref, dname)
                say(f"  {dname:8s} hd={hd:3d} B={B} S={S} {name}: strides {tuple(q.stride())}, "
                    f"{made} layout copies, {r:.2f} of tolerance")
                if not (r <= 1.0 and got.shape == (B, S, NH, hd) and got.is_contiguous()):
                    fail(f"model layout '{name}' disagrees: {r:.3f} of tolerance")
                if made != copies:
                    fail(f"model layout '{name}' took {made} layout copies, expected {copies}")

    # a captured call replayed on new values written into its inputs in place
    q, k, v = (randn(1, 512, n, 128, dtype=torch.bfloat16) for n in (NH, NKV, NKV))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mha_flash(q, k, v)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with capture(graph):
        out = mha_flash(q, k, v)
    for step in range(2):
        for t in (q, k, v):
            t.copy_(randn(*t.shape, dtype=t.dtype))
        out.fill_(float("nan"))
        graph.replay()
        ref = _ref_bshd(q, k, v, NH // NKV, causal=True)
        torch.cuda.synchronize()
        r = tol_ratio(out, ref, "bfloat16")
        say(f"  graph replay {step + 1} after writing new q, k, v in place: "
            f"{r:.2f} of tolerance")
        if not r <= 1.0:
            fail(f"a replay on inputs changed in place disagrees: {r:.3f} of tolerance")


def flash_timing(describe=None, q_heads: int = 24, kv_heads: int = 8,
                 lengths=TIMED_LENGTHS, model: str = "phi4-mini") -> dict:
    """B1 at a model's prefill shapes (q (q_heads,S,128), kv (kv_heads,S,128),
    bf16, causal, B=1; by default phi4-mini's, at every prefill bucket and
    S=2048): kernel, ``F.scaled_dot_product_attention`` (a yardstick only:
    the port never calls it) and the plain version, each inside a CUDA graph
    and launched from Python, beside the card's bound.  ``describe(q, k, v)``
    names the launch the kernel makes.  Returns the record of S=512, the
    largest prefill bucket, with every length under ``by_length``."""
    say(f"-- timing at {model} prefill shapes: q ({q_heads},S,128), kv ({kv_heads},S,128), "
        "bf16, causal; ms per call in a CUDA graph (graph) and launched from Python (eager)")
    record, by_length = {}, {}
    for S in lengths:
        entry = flash_time(q_heads, kv_heads, S, S, 128, True, f"S={S}", describe)
        by_length[S] = entry
        if S == max(PREFILL_BUCKETS):
            record = dict(entry)
    record["by_length"] = by_length
    return record


def flash_time(q_heads: int, kv_heads: int, Sq: int, Skv: int, hd: int, causal: bool,
               label: str, describe=None) -> dict:
    """B1 on q (q_heads, Sq, hd) and k/v (kv_heads, Skv, hd), bf16, against
    its plain version, then timed with ``F.scaled_dot_product_attention``
    and the plain version, each inside a CUDA graph and launched from
    Python, beside the card's bound; returns the record."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref

    group = q_heads // kv_heads
    q, k, v = _qkv(kv_heads, group, Sq, Skv, hd, torch.bfloat16, seed=100 + Sq)
    kw = dict(group=group, causal=causal)
    got, ref = flash_attention(q, k, v, **kw), flash_attention_ref(q, k, v, **kw)
    err = (got.float() - ref.float()).abs().max().item()
    if not tol_ratio(got, ref, "bfloat16") <= 1.0:
        fail(f"kernel disagrees at {label}: max_abs_err {err}")
    q4, k4, v4 = q[None], k[None], v[None]
    calls = {"kernel": lambda: flash_attention(q, k, v, **kw),
             "plain": lambda: flash_attention_ref(q, k, v, **kw),
             "library": lambda: F.scaled_dot_product_attention(
                 q4, k4, v4, is_causal=causal, enable_gqa=True)}
    iters = 50 if Sq * Skv <= 512 * 512 else 20
    graphed = {name: graph_ms(fn, reps=10 if name == "plain" else 20,
                              iters=5 if name == "plain" else iters)
               for name, fn in calls.items()}
    eager = {name: time_ms(fn, 5 if name == "plain" else iters)
             for name, fn in calls.items()}
    # (query, key) pairs per head: causal (top-left aligned) or all; 4*hd
    # operations each
    pairs = sum(min(i + 1, Skv) for i in range(Sq)) if causal else Sq * Skv
    flops = 4.0 * hd * q_heads * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    bound_ms, bound_by = bound(flops, nbytes, "bfloat16")
    launch = f" | {describe(q, k, v)}" if describe else ""
    say(f"  {label} (q ({q_heads},{Sq},{hd}) kv ({kv_heads},{Skv},{hd}) causal {int(causal)}): "
        f"graph kernel_ms {graphed['kernel']:.5f} plain_ms "
        f"{graphed['plain']:.5f} library_ms {graphed['library']:.5f} | eager "
        f"kernel_ms {eager['kernel']:.5f} plain_ms {eager['plain']:.5f} library_ms "
        f"{eager['library']:.5f} | bound_ms {bound_ms:.5f} ({bound_by}) | kernel at "
        f"{bound_ms / graphed['kernel']:.1%} of bound, "
        f"{graphed['library'] / graphed['kernel']:.3f}x the library's speed | "
        f"max_abs_err {err:.3e}{launch}")
    return dict(max_abs_err=err, ms=graphed["kernel"], plain_ms=graphed["plain"],
                bound_ms=bound_ms, bound_by=bound_by, library_ms=graphed["library"],
                eager_ms=eager["kernel"], eager_library_ms=eager["library"])


# phase 3b: B3 (decode attention) against its plain version at every shape
# the decode paths give it, at both dtypes: (label, arch, smoke, B, T, S,
# the deferred form with the step's own keys, one 0-d offset for every row)
DECODE_CASES = [
    ("phi4-mini served (phases 4, 16-18)", "phi4-mini-3.8b", False, SERVE_SLOTS, 1024, 1,
     True, False),
    ("phi4-mini 2 layers (phase 5)", "phi4-mini-3.8b", False, 4, 128, 1, True, False),
    ("decode_32k share (phase 20b)", "phi4-mini-3.8b", False, 8, 32768, 1, True, True),
    ("arctic-480b served (phase 8)", "arctic-480b", False, SERVE_SLOTS, 1024, 1, True, False),
    ("llava-next-34b served (phase 11)", "llava-next-34b", False, SERVE_SLOTS, 1024, 1,
     True, False),
    ("seamless-m4t-medium decoder (phase 12)", "seamless-m4t-medium", False, 4, 64, 1,
     False, False),
    ("zamba2-2.7b shared block (phase 13)", "zamba2-2.7b", False, 4, 64, 1, False, False),
    ("phi4-mini smoke lane (phase 16)", "phi4-mini-3.8b", True, SERVE_SLOTS, 1024, 1, True,
     False),
    ("arctic smoke (phase 10)", "arctic-480b", True, 4, 256, 1, True, False),
    ("llava-next smoke (phase 15)", "llava-next-34b", True, 4, 128, 1, True, False),
    ("seamless smoke (phase 15)", "seamless-m4t-medium", True, 4, 16, 1, False, False),
    ("zamba2 smoke (phase 15)", "zamba2-2.7b", True, 4, 16, 1, False, False),
    ("gemma2-27b local layer: window 4096, cap 50", "gemma2-27b", False, 4, 8192, 1, True,
     False),
    ("starcoder2-15b: GQA 12", "starcoder2-15b", False, 4, 1024, 1, True, False),
    ("GQA 7, 3 new tokens (two row tiles)", "arctic-480b", False, 2, 512, 3, True, False),
    ("GQA 7, 3 tokens, the cache form", "llava-next-34b", False, 2, 512, 3, False, False),
]
# the shapes B3 is timed at, every served decode shape: phi4-mini's served
# decode (the record's top level), decode_32k's share, arctic and llava
# served (GQA 7), starcoder2 (GQA 12), gemma2's windowed layer, seamless's
# and zamba2's cache forms (T 64, hd 64 and 80)
DECODE_TIMED = (0, 2, 3, 4, 13, 12, 5, 6)
# B3's tolerance, |got - ref| <= atol + rtol * |ref| elementwise.  float32
# as B1's (summation order).  bf16: rtol covers the two outputs' roundings
# (half a bf16 ulp each, 2**-8 of |ref| together); the plain version also
# rounds every probability to bf16 before the product with v, an error that
# scales with the row's values, so atol is DECODE_BF16_RMS x the rms of the
# reference row (over hd), about 4x the largest |err| / rms a row showed in
# phase 3b on an H100 (PERF.md).  A fixed atol would be looser than a long
# cache's outputs themselves: at decode_32k they are about 0.01.
DECODE_BF16_RMS = 0.125
DECODE_TOL = {"float32": (1e-4, 0.0), "bfloat16": (DECODE_BF16_RMS, 1e-2)}


def decode_ratio(got, ref, dname: str) -> float:
    """Largest ``|got - ref| / (atol + rtol * |ref|)`` at B3's tolerance for
    ``dname``, bf16's atol scaled by each row's rms: within it at <= 1."""
    ref = ref.float()
    atol, rtol = DECODE_TOL[dname]
    if dname == "bfloat16":
        atol = atol * ref.pow(2).mean(-1, keepdim=True).sqrt()
    return ((got.float() - ref).abs() / (atol + rtol * ref.abs())).max().item()


def rms_err(got, ref) -> float:
    """The largest ``|got - ref|`` of a row over that row's rms in ``ref``."""
    ref = ref.float()
    return ((got.float() - ref).abs() / ref.pow(2).mean(-1, keepdim=True).sqrt()).max().item()


def _decode_inputs(arch, smoke, B, T, S, new, kvv0d, dtype, seed, full=False):
    """q, one layer's cache as a strided view of a 2-layer cache (layer 1),
    the step's keys (the deferred form), positions and kv_valid, and the
    call's keywords, for ``arch``'s heads, on the card.  Offsets are spread
    over [0, T] (the cache form: pos over [0, T - S], kv_valid = pos + S),
    or near the end with ``full``."""
    import torch

    import repro_torch.configs as C

    cfg = C.get(arch, smoke=smoke)
    NH, NKV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    q = randn(B, S, NH, hd)
    if cfg.attn_softcap:
        q = q * CAP_Q_SCALE                       # a power of 2: exact in bf16
    k_cache, v_cache = randn(2, B, T, NKV, hd)[1], randn(2, B, T, NKV, hd)[1]
    k_new = v_new = None
    if new:
        k_new, v_new = randn(B, S, NKV, hd), randn(B, S, NKV, hd)
    top = T if new else T - S
    if kvv0d:
        start = torch.tensor(top - 16 if full else top // 2 + 5, device="cuda")
        kv_valid = start
        positions = start + torch.arange(S, device="cuda")
    else:
        start = torch.randint(0, top + 1, (B,), generator=g, device="cuda")
        if full:
            start = top - 1 - torch.arange(B, device="cuda") % top
        elif B > 1:
            start[0], start[1] = 0, top
        positions = start[:, None] + torch.arange(S, device="cuda")[None, :]
        kv_valid = start if new else start + S
    window = cfg.sliding_window if cfg.local_global_pattern else None
    kw = dict(positions=positions, kv_valid=kv_valid,
              scale=cfg.attn_logit_scale or 1.0 / math.sqrt(hd),
              softcap=cfg.attn_softcap, window=window)
    return q, k_cache, v_cache, k_new, v_new, kw


def phase_decode_kernel() -> dict:
    import torch

    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.decode_attention import kernel as decode

    say("== phase 3b: decode_attention (B3) vs plain version at every decode path's shape, "
        "both dtypes (tolerance |err| <= atol + rtol*|ref|: f32 1e-4 + 0 for summation "
        f"order; bf16 {DECODE_BF16_RMS:g} x the row's rms(ref) + 1e-2*|ref| for the plain "
        "version's bf16 probabilities and the outputs' rounding; err/rms is a row's largest "
        f"|err| over its rms(ref); soft-cap cases scale q by {CAP_Q_SCALE:g})")
    worst, worst_rms, reached, failed = 0.0, 0.0, {}, []
    for i, (label, arch, smoke, B, T, S, new, kvv0d) in enumerate(DECODE_CASES):
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            q, kc, vc, kn, vn, kw = _decode_inputs(arch, smoke, B, T, S, new, kvv0d, dtype,
                                                   seed=300 + i)
            launch = decode.launch_for(q, kc, new, kw["window"])
            got = decode_attention(q, kc, vc, kn, vn, **kw)
            ref = decode_attention_ref(q, kc, vc, kn, vn, **kw)
            torch.cuda.synchronize()
            key = (dname, q.shape[-1], launch.rows)
            reached[key] = reached.get(key, 0) + 1
            err = (got.float() - ref.float()).abs().max().item()
            r, er = decode_ratio(got, ref, dname), rms_err(got, ref)
            ok = math.isfinite(err) and r <= 1.0
            note = ""
            if kw["softcap"]:
                uncapped = decode_attention_ref(q, kc, vc, kn, vn, **{**kw, "softcap": 0.0})
                moved = (uncapped.float() - ref.float()).abs().max().item()
                note = (f" | cap moves the output by {moved:.3e}, "
                        f"{decode_ratio(uncapped, ref, dname):.1f}x the tolerance")
                if not moved >= 10 * TOL[dname][0]:
                    fail(f"soft-cap moves the output by only {moved}: the case is blind to it")
            if kvv0d:
                # the synchronized step's 0-d offset against the same offset per row
                per_row = decode_attention(q, kc, vc, kn, vn, **{
                    **kw, "kv_valid": kw["kv_valid"].expand(B).clone(),
                    "positions": kw["positions"].expand(B, S).clone()})
                same = torch.equal(got, per_row)
                note += f" | 0-d offset == per-row offsets: {same}"
                if not same:
                    fail(f"{label}: B3 with a 0-d kv_valid differs from the same per row")
            say(f"  {dname:8s} {label}: B={B} T={T} S={S} heads {q.shape[2]}/{kc.shape[2]} "
                f"hd={q.shape[-1]} {'deferred' if new else 'cache form'} | {plan_text(launch)} "
                f"| max_abs_err {err:.3e}, err/rms {er:.3e} ({r:.2f} of tolerance) "
                f"{'ok' if ok else 'FAIL'}{note}")
            if not ok:
                failed.append(f"{label} {dname} ({r:.3f} of tolerance)")
            worst = max(worst, r)
            if dname == "bfloat16":
                worst_rms = max(worst_rms, er)
            del q, kc, vc, kn, vn, got, ref
    if failed:
        fail(f"B3 disagrees with its plain version at {failed}")
    say(f"  {2 * len(DECODE_CASES)} cases within tolerance (worst at {worst:.2f} of its "
        f"tolerance; bf16's largest err/rms {worst_rms:.3e}, its atol {DECODE_BF16_RMS:g} x "
        "rms); cases by kernel (dtype, hd, rows): "
        + ", ".join(f"{d} {hd} {r} x{n}" for (d, hd, r), n in sorted(reached.items())))
    decode_masked_row()
    record = decode_time(*DECODE_CASES[DECODE_TIMED[0]])
    record["decode_32k"] = decode_time(*DECODE_CASES[DECODE_TIMED[1]])
    record["served_shapes"] = {DECODE_CASES[i][0]: decode_time(*DECODE_CASES[i])
                               for i in DECODE_TIMED[2:]}
    record["checked_instances"] = sorted(reached)
    return record


def plan_text(launch) -> str:
    """B3's plan as 3b prints it, with how many of its clusters the card
    holds at once; a plan without clusters (an older kernel's, timed
    beside this one) prints its fields."""
    from repro_torch.kernels.decode_attention import kernel as decode

    if not hasattr(launch, "cluster"):
        return str(launch)
    return (f"cluster {launch.cluster}, stages {launch.stages}, chunk {launch.chunk}, rows "
            f"{launch.rows} x{launch.row_tiles}, grid {launch.grid}, smem {launch.smem_bytes}, "
            f"{decode.max_active_clusters(launch)} clusters resident at most")


def decode_masked_row() -> None:
    """A row whose every key is masked (no decode path makes one: a step's
    token sees itself): the kernel writes 0, the plain version the mean of
    v over every position, as the JAX package's softmax does."""
    import torch

    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref

    q, kc, vc, _, _, kw = _decode_inputs("phi4-mini-3.8b", True, 2, 128, 1, False, False,
                                         torch.float32, seed=299)
    kw["positions"] = kw["positions"].clone()
    kw["positions"][0] = -1                      # row 0 sees no key
    got = decode_attention(q, kc, vc, **kw)
    ref = decode_attention_ref(q, kc, vc, **kw)
    zero = bool((got[0] == 0).all())
    rest = ratio(got[1:], ref[1:], *TOL["float32"])
    say(f"  a fully masked row: kernel {'0' if zero else 'NOT 0'}, plain version the mean of "
        f"v (max |ref| {ref[0].abs().max().item():.3e}); the other row within "
        f"{rest:.2f} of tolerance")
    if not zero or rest > 1.0:
        fail("B3's fully masked row is not 0, or the other row disagrees")


def decode_time(label, arch, smoke, B, T, S, new, kvv0d) -> dict:
    """B3 at one of the paths' shapes, bf16, offsets near the end of the
    cache: in a CUDA graph and launched from Python, beside the plain
    version, the library (one ``F.scaled_dot_product_attention`` over the
    cache with a boolean mask and ``enable_gqa=True``, without the step's
    own keys, with the window, without the soft-cap: a yardstick only, the
    port never calls it) and the bound: the K and V of the cache positions
    some query row sees (valid, causal, in the window), q, the new keys and
    values and the output, once each, against the products' operations at
    the card's peak for the cache's dtype (bf16: the tensor cores)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.decode_attention import kernel as decode

    q, kc, vc, kn, vn, kw = _decode_inputs(arch, smoke, B, T, S, new, kvv0d, torch.bfloat16,
                                           seed=400 + T, full=True)
    NH, NKV, hd = q.shape[2], kc.shape[2], q.shape[3]
    kvv = kw["kv_valid"].expand(B).clamp(max=T)
    pos = kw["positions"].expand(B, S)
    t = torch.arange(T, device="cuda")
    seen = (t[None, None, :] < kvv[:, None, None]) & (t[None, None, :] <= pos[..., None])
    if kw["window"]:
        seen &= t[None, None, :] > pos[..., None] - kw["window"]
    visible = int(seen.any(1).sum())
    got = decode_attention(q, kc, vc, kn, vn, **kw)
    ref = decode_attention_ref(q, kc, vc, kn, vn, **kw)
    err = (got.float() - ref.float()).abs().max().item()
    if not decode_ratio(got, ref, "bfloat16") <= 1.0:
        fail(f"B3 disagrees at {label} (timing inputs): max_abs_err {err}, err/rms "
             f"{rms_err(got, ref):.3e}")
    q4, k4, v4 = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    mask = seen[:, None]
    backend = None
    for b in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]), warnings.catch_warnings():
                warnings.simplefilter("ignore")     # each refusal warns of its reasons
                F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True,
                                               scale=kw["scale"])
            backend = b
            break
        except RuntimeError:
            continue
    if backend is None:
        fail("no F.scaled_dot_product_attention backend takes the decode shape")

    def library():
        with sdpa_kernel([backend]):
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True,
                                                  scale=kw["scale"])

    before = decode.launches
    calls = {"kernel": lambda: decode_attention(q, kc, vc, kn, vn, **kw),
             "plain": lambda: decode_attention_ref(q, kc, vc, kn, vn, **kw),
             "library": library}
    big = T * B > 65536
    graphed = {name: graph_ms(fn, reps=2 if big else 10, iters=5 if big else 20)
               for name, fn in calls.items()}
    eager_ms = time_ms(calls["kernel"], 5 if big else 20)
    decode.launches = before                   # timing launches are not a path's
    esize = q.element_size()
    nbytes = (2 * visible * NKV * hd + 2 * q.numel()
              + (2 * kn.numel() if new else 0)) * esize + 8 * (B + B * S)
    keys = visible + (B * S if new else 0)
    bound_ms, bound_by = bound(4.0 * hd * (NH // NKV) * S * NKV * keys, nbytes, "bfloat16")
    launch = decode.launch_for(q, kc, new, kw["window"])
    say(f"-- B3 timing at {label}: q ({B},{S},{NH},{hd}) over a bf16 cache of {T} positions, "
        f"{NKV} kv heads, {visible} visible positions | graph kernel_ms {graphed['kernel']:.5f} "
        f"plain_ms {graphed['plain']:.5f} library_ms {graphed['library']:.5f} "
        f"({backend.name}) | eager kernel_ms {eager_ms:.5f} | bound_ms {bound_ms:.5f} "
        f"({bound_by}, {nbytes / 1e6:.3f} MB) | kernel at {bound_ms / graphed['kernel']:.1%} "
        f"of bound, {graphed['library'] / graphed['kernel']:.3f}x the library's speed | "
        f"{plan_text(launch)} | max_abs_err {err:.3e}")
    return dict(shape=[B, T, S, NH, NKV, hd], max_abs_err=err, ms=graphed["kernel"],
                eager_ms=eager_ms, plain_ms=graphed["plain"], library_ms=graphed["library"],
                library_backend=backend.name, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes)


# phase 3c: B6 (latent attention) against its plain version at every shape
# a DeepSeek-V2 path gives it: (label, B, S, T, N, R, Rr, dtype, a 0-d
# offset for every row, the prompt pass (positions 0..S-1 over the prompt's
# own latents, T = S))
LATENT_CASES = [
    ("served decode (phases 9, 16)", SERVE_SLOTS, 1, 1024, 128, 512, 64, "bfloat16", False,
     False),
    ("3 new tokens", SERVE_SLOTS, 3, 1024, 128, 512, 64, "bfloat16", False, False),
    *[(f"prefill bucket {b} (phases 9, 16)", 1, b, b, 128, 512, 64, "bfloat16", False, True)
      for b in PREFILL_BUCKETS],
    ("decode_32k share (phase 23)", 8, 1, 32768, 128, 512, 64, "bfloat16", True, False),
    ("smoke decode (phase 10)", 4, 1, 256, 4, 32, 16, "float32", False, False),
    *[(f"smoke prefill bucket {b} (phase 10)", 1, b, b, 4, 32, 16, "float32", False, True)
      for b in (16, 128)],
    ("smoke widths at bf16", 4, 1, 256, 4, 32, 16, "bfloat16", False, False),
    # the edges of the bf16 kernel's schedule (prefill bucket 64 above is a
    # chunk of one tile: warpgroup 1 scores nothing)
    ("a chunk of an odd number of tiles: T 320 over 3 splits", 2, 1, 320, 128, 512, 64,
     "bfloat16", False, False),
    ("T 1000: a ragged last tile", SERVE_SLOTS, 1, 1000, 128, 512, 64, "bfloat16", False, False),
    ("T 96: a visible end inside a pair's second tile", SERVE_SLOTS, 1, 96, 128, 512, 64,
     "bfloat16", False, False),
    ("a prompt of 192 tokens: a pair and a lone tile", 1, 192, 192, 128, 512, 64, "bfloat16",
     False, True),
]
# the shapes B6 is timed at: the served decode, decode_32k's share, prefill
# bucket 512
LATENT_TIMED = (0, 6, 5)
# B6's tolerance: B3's (DECODE_TOL), bf16's atol scaled by each output
# row's rms; float32 summation order
LATENT_TOL = DECODE_TOL


def _latent_inputs(B, S, T, N, R, Rr, dtype, kvv0d, prompt, seed, full=False):
    """q_lat, q_rope, ckv, krope, positions, kv_len and the scale, on the
    card, in the layouts the served path gives them: q_lat a permuted view
    of (N, B, S, R) storage (the einsum's output), q_rope a slice of the
    (B, S, N, 128 + Rr) query, ckv and krope layer 1 of a 2-layer cache.
    Offsets: the prompt pass 0..S-1 over T = S; a decode step's slots spread
    over [0, T - S] (with ``full``, near the end), kv_len = pos + S; a 0-d
    offset as the synchronized step passes it."""
    import torch

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dt)

    q_lat = randn(N, B, S, R).permute(1, 2, 0, 3)
    q_rope = randn(B, S, N, 128 + Rr)[..., 128:]
    ckv, krope = randn(2, B, T, R)[1], randn(2, B, T, Rr)[1]
    ar = torch.arange(S, device="cuda")
    if prompt:
        positions, kv_len = ar[None].expand(B, S).clone(), torch.full((B,), S, device="cuda")
    elif kvv0d:
        pos = torch.tensor(T - S - 16 if full else (T - S) // 2 + 5, device="cuda")
        positions, kv_len = pos + ar, pos + S
    else:
        pos = torch.randint(0, T - S + 1, (B,), generator=g, device="cuda")
        if full:
            pos = T - S - torch.arange(B, device="cuda") % 7
        elif B > 1:
            pos[0], pos[1] = 0, T - S
        positions, kv_len = pos[:, None] + ar[None, :], pos + S
    return q_lat, q_rope, ckv, krope, positions, kv_len, 1.0 / math.sqrt(128 + Rr)


def latent_plan_text(launch, B, S, N) -> str:
    """B6's plan as 3c prints it."""
    return (f"grid {launch.grid(B, S, N)}, rows {launch.rows}, split {launch.split} x {launch.chunk} "
            f"positions, smem {launch.smem_bytes}, {launch.kernels} "
            f"kernel{'s' if launch.kernels > 1 else ''} a call")


def phase_latent_kernel() -> dict:
    import torch

    from repro_torch.kernels.latent_attention import kernel as b6
    from repro_torch.kernels.latent_attention import latent_attention, latent_attention_ref

    say("== phase 3c: latent_attention (B6) vs plain version at every DeepSeek-V2 path's "
        "shape (tolerance B3's: f32 1e-4 + 0 for summation order; bf16 "
        f"{DECODE_BF16_RMS:g} x the row's rms(ref) + 1e-2*|ref| for the plain version's "
        "bf16 probabilities and the outputs' rounding)")
    ptxas = latent_registers()
    for name, rep in sorted(ptxas.items()):
        say(f"  ptxas {name}: {rep.get('registers')} registers, spills (stores, loads) "
            f"{rep.get('spills')}{', wgmma serialized' if rep.get('serialized') else ''}")
    bad = [name for name, rep in ptxas.items() if name.startswith("latent_attention_kernel")
           and (rep.get("spills") != (0, 0) or rep.get("serialized"))]
    if bad or not any(name.startswith("latent_attention_kernel") for name in ptxas):
        fail(f"B6's bf16 kernel spills registers or has its wgmma serialized ({bad}), or "
             "ptxas reported none of it")
    worst, failed = 0.0, []
    for i, (label, B, S, T, N, R, Rr, dname, kvv0d, prompt) in enumerate(LATENT_CASES):
        args = _latent_inputs(B, S, T, N, R, Rr, dname, kvv0d, prompt, seed=500 + i)
        *ten, scale = args
        launch = b6.launch_for(*ten[:3])
        with torch.no_grad():
            got = latent_attention(*ten, scale=scale)
            ref = latent_attention_ref(*ten, scale=scale)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        r, er = decode_ratio(got, ref, dname), rms_err(got, ref)
        ok = math.isfinite(err) and r <= 1.0
        with torch.no_grad():
            again = latent_attention(*ten, scale=scale)
        note = f" | again: the same bits {torch.equal(got, again)}"
        if not torch.equal(got, again):
            fail(f"{label} ({dname}): two runs of B6 on the same inputs differ")
        if kvv0d:
            q_lat, q_rope, ckv, krope, positions, kv_len = ten
            per_row = latent_attention(q_lat, q_rope, ckv, krope,
                                       positions.expand(B, S).clone(), kv_len.expand(B).clone(),
                                       scale=scale)
            same = torch.equal(got, per_row)
            note += f" | 0-d offset == per-row offsets: {same}"
            if not same:
                fail(f"{label}: B6 with a 0-d offset differs from the same offset per row")
        say(f"  {dname:8s} {label}: B={B} S={S} T={T} N={N} R={R} Rr={Rr} | "
            f"{latent_plan_text(launch, B, S, N)} | max_abs_err {err:.3e}, err/rms {er:.3e} "
            f"({r:.2f} of tolerance) {'ok' if ok else 'FAIL'}{note}")
        if not ok:
            failed.append(f"{label} {dname} ({r:.3f} of tolerance)")
        worst = max(worst, r)
        del args, ten, got, ref
    if failed:
        fail(f"B6 disagrees with its plain version at {failed}")
    say(f"  {len(LATENT_CASES)} cases within tolerance (worst at {worst:.2f} of its tolerance)")
    latent_masked_row()
    record = latent_time(*LATENT_CASES[LATENT_TIMED[0]])
    record["decode_32k"] = latent_time(*LATENT_CASES[LATENT_TIMED[1]])
    record["prefill_512"] = latent_time(*LATENT_CASES[LATENT_TIMED[2]])
    record["ptxas"] = {name: rep for name, rep in ptxas.items()
                       if name.startswith("latent_attention_kernel")}
    return record


def latent_masked_row() -> None:
    """A row whose every key is masked (position -1): B6 gives the mean of
    the latents over every position, as the plain version and JAX's
    softmax of -1e30 logits do, at both dtypes and with and without a split."""
    import torch

    from repro_torch.kernels.latent_attention import kernel as b6
    from repro_torch.kernels.latent_attention import latent_attention, latent_attention_ref

    for dname, N, R, Rr in (("bfloat16", 128, 512, 64), ("float32", 4, 32, 16)):
        *ten, scale = _latent_inputs(2, 1, 256, N, R, Rr, dname, False, False, seed=499)
        ten[4] = ten[4].clone()
        ten[4][0] = -1                                 # slot 0's query sees no key
        with torch.no_grad():
            got = latent_attention(*ten, scale=scale)
            ref = latent_attention_ref(*ten, scale=scale)
        mean = ten[2][0].float().mean(0)
        r = decode_ratio(got, ref, dname)
        to_mean = (got[0, 0].float() - mean).abs().max().item()
        say(f"  {dname} a fully masked row (split {b6.launch_for(*ten[:3]).split}): "
            f"{r:.2f} of tolerance from the plain version over both slots; the masked row "
            f"within {to_mean:.3e} of the latents' mean")
        if not r <= 1.0 or not to_mean <= 0.02:
            fail(f"B6's fully masked row ({dname}) is not the latents' mean, or the other "
                 "slot disagrees")


# the warning that heads each SDPA backend's reasons for refusing a call
SDPA_HEADERS = {"FLASH_ATTENTION": "Flash attention kernel",
                "EFFICIENT_ATTENTION": "Memory efficient kernel",
                "CUDNN_ATTENTION": "cuDNN attention kernel"}


def sdpa_reasons(backend: str, messages: list[str]) -> str:
    """The reasons ``backend`` gave for refusing a call, from the warnings
    PyTorch raised (each backend's headed by its ``SDPA_HEADERS`` line;
    the others only say they were disabled)."""
    lines = [" ".join(re.sub(r"\(Triggered internally at [^)]*\)\.?", "", m).split())
             for m in messages]
    own, mine = [], False
    for line in lines:
        if line.endswith("not used because:"):
            mine = line.startswith(SDPA_HEADERS.get(backend, "?"))
        elif mine:
            own.append(line)
    return "; ".join(own or lines)[:300]


def latent_library(q_lat, q_rope, ckv, krope, seen, scale, causal) -> tuple[dict, dict, dict]:
    """B6's library yardstick: one ``F.scaled_dot_product_attention`` call
    over q = [q_lat | q_rope], k = [ckv | krope], v = ckv and the boolean
    mask ``seen`` (B, S, T), in three layouts of the same inputs: ``gqa``
    (the N query heads over one kv head, ``enable_gqa``), ``expanded`` (k
    and v expanded to N heads as views) and ``folded`` (the N heads folded
    into the query rows of one head, as B6 folds them); with ``causal``
    (a prompt pass, where ``seen`` is the causal mask) ``gqa`` and
    ``expanded`` also as ``is_causal`` with no mask.  Each fused backend is
    tried in each layout, MATH in the folded one (in the others it would
    repeat the cache N times).  Returns the calls that ran by
    "BACKEND/layout", each giving the (B, S, N, R) context as a view; the
    refusals by the same key, with the backend's reasons; and the backend
    the default dispatch picks in each layout."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    B, S, N, R = q_lat.shape
    T = ckv.shape[1]
    q = torch.cat([q_lat, q_rope], -1)                             # (B, S, N, R + Rr)
    k = torch.cat([ckv, krope], -1)[:, None]                       # (B, 1, T, R + Rr)
    v = ckv[:, None]

    def heads(o):                                                  # (B, N, S, R) -> (B, S, N, R)
        return o.transpose(1, 2)

    layouts = {
        "gqa": (q.transpose(1, 2), k, v, seen[:, None], True, heads),
        "expanded": (q.transpose(1, 2), k.expand(B, N, T, -1), v.expand(B, N, T, -1),
                     seen[:, None], False, heads),
        "folded": (q.reshape(B, 1, S * N, -1), k, v,
                   seen[:, :, None].expand(B, S, N, T).reshape(B, 1, S * N, T), False,
                   lambda o: o.view(B, S, N, R)),
    }
    if causal:
        layouts["gqa/causal"] = (*layouts["gqa"][:3], None, True, heads)
        layouts["expanded/causal"] = (*layouts["expanded"][:3], None, False, heads)
    names = {b.value: b.name for b in SDPBackend.__members__.values()}
    default = {}
    for layout, (qq, kk, vv, mask, gqa, _) in layouts.items():
        try:
            default[layout] = names.get(int(torch._fused_sdp_choice(
                qq, kk, vv, attn_mask=mask, is_causal=mask is None, scale=scale,
                enable_gqa=gqa)), "?")
        except (RuntimeError, AttributeError, TypeError) as e:
            default[layout] = f"not known ({type(e).__name__})"

    def call(backend, layout):
        qq, kk, vv, mask, gqa, back = layouts[layout]

        def fn():
            with sdpa_kernel([backend]):
                return back(F.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mask, is_causal=mask is None, scale=scale,
                    enable_gqa=gqa))
        return fn

    ran, refused = {}, {}
    tries = [(b, lay) for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                                SDPBackend.CUDNN_ATTENTION) for lay in layouts]
    for backend, layout in tries + [(SDPBackend.MATH, "folded")]:
        key, fn = f"{backend.name}/{layout}", call(backend, layout)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                fn()
                torch.cuda.synchronize()
                ran[key] = fn
            except RuntimeError as e:
                refused[key] = sdpa_reasons(backend.name, [str(w.message) for w in caught]) \
                    or str(e).splitlines()[0][:300]
    return ran, refused, default


def latent_time(label, B, S, T, N, R, Rr, dname, kvv0d, prompt) -> dict:
    """B6 at one of the paths' shapes, bf16, offsets near the end of the
    cache: in a CUDA graph and launched from Python, beside the plain
    version, the library (:func:`latent_library`'s fastest call that gives
    finite values: a yardstick only, the port never calls it) and the
    bound: the [ckv | krope] rows some query sees, q and the output once
    each, against the products' operations over the keys each query sees
    at the bf16 peak."""
    import torch

    from repro_torch.kernels.latent_attention import kernel as b6
    from repro_torch.kernels.latent_attention import latent_attention, latent_attention_ref

    *ten, scale = _latent_inputs(B, S, T, N, R, Rr, dname, kvv0d, prompt, seed=600 + T,
                                 full=True)
    q_lat, q_rope, ckv, krope, positions, kv_len = ten
    pos = positions.expand(B, S)
    kvl = kv_len.expand(B)
    t = torch.arange(T, device="cuda")
    seen = (t[None, None, :] <= pos[..., None]) & (t[None, None, :] < kvl[:, None, None])
    rows_seen = int(seen.any(1).sum())                 # cache rows some query sees
    keys = int(seen.sum())                             # (query token, key) pairs
    with torch.no_grad():
        got = latent_attention(*ten, scale=scale)
        ref = latent_attention_ref(*ten, scale=scale)
    err = (got.float() - ref.float()).abs().max().item()
    if not decode_ratio(got, ref, dname) <= 1.0:
        fail(f"B6 disagrees at {label} (timing inputs): max_abs_err {err}")
    ran, refused, default = latent_library(q_lat, q_rope, ckv, krope, seen, scale, prompt)
    lib_ratio = {}
    for key, fn in list(ran.items()):
        out = fn()
        if not torch.isfinite(out).all():
            refused[key] = "ran, but its output is not finite"
            del ran[key]
        else:
            lib_ratio[key] = decode_ratio(out, ref, dname)
        del out

    before = b6.launches
    calls = {"kernel": lambda: latent_attention(*ten, scale=scale),
             "plain": lambda: latent_attention_ref(*ten, scale=scale)}
    big = B * T * N * S > 2**24
    reps, iters = (2, 5) if big else (10, 20)
    with torch.no_grad():
        graphed = {name: graph_ms(fn, reps, iters) for name, fn in calls.items()}
        eager_ms = time_ms(calls["kernel"], iters)
        for key, fn in list(ran.items()):
            try:
                graphed[key] = graph_ms(fn, reps, iters)
            except RuntimeError as e:
                torch.cuda.synchronize()
                refused[key] = f"ran, but not in a CUDA graph: {str(e).splitlines()[0][:200]}"
                del ran[key]
    b6.launches = before                       # timing launches are not a path's
    esize = q_lat.element_size()
    nbytes = (rows_seen * (R + Rr) + q_lat.numel() // R * (R + Rr) + got.numel()) * esize \
        + 8 * (positions.numel() + kv_len.numel())
    bound_ms, bound_by = bound(2.0 * N * keys * (2 * R + Rr), nbytes, "bfloat16")
    launch = b6.launch_for(q_lat, q_rope, ckv)
    lib_ms = {key: graphed[key] for key in ran}
    best = min(lib_ms, key=lib_ms.get) if lib_ms else None
    say(f"-- B6 timing at {label}: q ({B},{S},{N},{R}+{Rr}) over a {dname} cache of {T} "
        f"positions, {rows_seen} rows seen | graph kernel_ms {graphed['kernel']:.5f} "
        f"plain_ms {graphed['plain']:.5f} library_ms "
        + (f"{lib_ms[best]:.5f} ({best})" if best else "none (every call refused)")
        + f" | eager kernel_ms {eager_ms:.5f} | bound_ms {bound_ms:.5f} ({bound_by}, "
        f"{nbytes / 1e6:.3f} MB, {2.0 * N * keys * (2 * R + Rr) / 1e9:.3f} GFLOP) | kernel at "
        f"{bound_ms / graphed['kernel']:.1%} of bound, {graphed['plain'] / graphed['kernel']:.2f}x "
        f"the plain version's speed"
        + (f", {lib_ms[best] / graphed['kernel']:.2f}x the library's" if best else "")
        + f" | {latent_plan_text(launch, B, S, N)} | max_abs_err {err:.3e}")
    say(f"   SDPA at {label}: the default dispatch picks {default}; ran "
        + (", ".join(f"{key} {ms:.5f} ms ({lib_ratio[key]:.2f} of B6's tolerance from the "
                     "plain version)" for key, ms in lib_ms.items()) or "nothing"))
    for key, why in refused.items():
        say(f"   SDPA {key} refused: {why}")
    return dict(shape=[B, S, T, N, R, Rr], max_abs_err=err, ms=graphed["kernel"],
                eager_ms=eager_ms, plain_ms=graphed["plain"],
                library_ms=lib_ms[best] if best else None, library_backend=best,
                library_ms_by_call=lib_ms, library_tolerance_ratio=lib_ratio,
                library_default=default, library_refusals=refused, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, kernels_per_call=launch.kernels)


# ---------------------------------------------------------------------------
# phase 3d: expanded attention (B7), forward and backward
# ---------------------------------------------------------------------------

# (label, B, S, N, nope, rope, dv, dtype, positions): q (B, S, N, nope +
# rope) split into its two views, k_rope the [:, :, 0, :] view of (B, S, 1,
# rope), T = S; positions "arange" (every caller's), "mixed" (a permutation
# with repeats, negative entries whose rows see no key, entries past S),
# "sharp" (arange, q and k drawn 4 times as large: logits of standard
# deviation 16, so each row's softmax peaks on a few keys)
EXPANDED_CASES = [
    ("19h: deepseek-v2-236b's train step, 2 x 4096", 2, 4096, 128, 128, 64, 128, "bfloat16",
     "arange"),
    ("train_4k's share of a 16x16 device", 16, 4096, 8, 128, 64, 128, "bfloat16", "arange"),
    *[(f"S {S}", 2, S, 8, 128, 64, 128, "bfloat16", "arange") for S in (1, 63, 65, 512)],
    ("S 1000: ragged tiles", 2, 1000, 8, 128, 64, 128, "bfloat16", "arange"),
    ("a q_pos that is not arange", 2, 300, 8, 128, 64, 128, "bfloat16", "mixed"),
    ("the smoke widths at bf16", 2, 200, 4, 32, 16, 32, "bfloat16", "arange"),
    ("19d: deepseek-v2-smoke at float32", 2, 64, 4, 32, 16, 32, "float32", "arange"),
    ("float32, ragged, a q_pos that is not arange", 2, 130, 4, 32, 16, 32, "float32", "mixed"),
    ("21b: the sharded forward's prompt, 2 x 256", 2, 256, 128, 128, 64, 128, "bfloat16",
     "arange"),
    ("large scores: q and k times 4, S 1000", 2, 1000, 8, 128, 64, 128, "bfloat16", "sharp"),
    ("S 129: a 128-row tile and one row", 2, 129, 8, 128, 64, 128, "bfloat16", "arange"),
]
# the shapes B7 is timed at: 19h's and the train_4k share
EXPANDED_TIMED = (0, 1)
# B7's tolerance, |got - ref| <= atol + rtol * |ref| elementwise, the
# reference computed in float32 from the same inputs.  float32: 1e-4 + 1e-4
# (summation order, as B1's backward).  bf16: the output takes B3's
# (DECODE_TOL: the bf16 probabilities and the output's rounding); each
# gradient rtol 2**-7 (its own bf16 rounding, half an ulp: 2**-9, and D =
# rowsum(dO * o) from the bf16 output, about 2**-9 more of dS) and atol
# 2**-7 of the larger of the gradient's largest |ref| and 1 (sums over up
# to 4096 queries or keys of terms with those errors; P and dS enter their
# products to about 16 bits, as B1's backward; the inputs are unit normal,
# and a gradient that is 0 by symmetry, as dq and dk at S 1, where each
# row's softmax is 1, comes out as rounding noise)
EXPANDED_GRAD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2.0 ** -7, 2.0 ** -7)}
EXPANDED_GRADS = ("dq_nope", "dq_rope", "dk_nope", "dk_rope", "dv")


def _expanded_inputs(B, S, N, nope, rope, dv, dname, kind, seed):
    """q_nope, q_rope, k_nope, k_rope, v, q_pos, dO and the scale on the
    card, in the layouts the model gives them: q_nope and q_rope the split
    views of one (B, S, N, nope + rope) query, k_rope the [:, :, 0, :] view
    of (B, S, 1, rope)."""
    import torch

    dt = getattr(torch, dname)
    g = torch.Generator(device="cuda").manual_seed(seed)
    qk = 4.0 if kind == "sharp" else 1.0

    def randn(*shape, mul=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * mul).to(dt)

    q_nope, q_rope = randn(B, S, N, nope + rope, mul=qk).split([nope, rope], dim=-1)
    k_nope, k_rope = randn(B, S, N, nope, mul=qk), randn(B, S, 1, rope, mul=qk)[:, :, 0, :]
    v = randn(B, S, N, dv)
    q_pos = torch.arange(S, device="cuda")
    if kind == "mixed":
        q_pos = torch.randint(-3, S + 4, (S,), generator=g, device="cuda")
        q_pos[:3] = torch.tensor([-1, S + 2, 0], device="cuda")
    return q_nope, q_rope, k_nope, k_rope, v, q_pos, randn(B, S, N, dv), 1.0 / math.sqrt(nope + rope)


def expanded_plain(ten, do, scale, backward=True):
    """The plain version's forward and, with ``backward``, its backward on
    ``ten`` (q_nope, q_rope, k_nope, k_rope, v, q_pos) and ``do`` as given, a
    few batch rows and heads at a time so that each chunk's (b, n, S, T)
    float32 scores stay within 2 GiB: ``(o, lse, grads)`` in float32
    (``grads`` None without ``backward``), dK_rope the chunks' float32 sum
    over the heads."""
    import torch

    from repro_torch.kernels.expanded_attention import (expanded_attention_bwd_ref,
                                                        expanded_attention_ref)

    q_nope, q_rope, k_nope, k_rope, v, q_pos = ten
    B, S, N, _ = q_nope.shape
    T = k_nope.shape[1]
    per = max(1, 2 ** 31 // (4 * S * T))           # (batch row, head) pairs a chunk
    hn = min(N, per)
    bn = max(1, min(B, per // hn))
    o = torch.empty(do.shape, device="cuda")
    lse = torch.empty((B, N, S), device="cuda")
    grads = [torch.zeros(t.shape, device="cuda") for t in ten[:5]] if backward else None
    for b0 in range(0, B, bn):
        for h0 in range(0, N, hn):
            bs, hs = slice(b0, b0 + bn), slice(h0, h0 + hn)
            part = [q_nope[bs, :, hs], q_rope[bs, :, hs], k_nope[bs, :, hs], k_rope[bs],
                    v[bs, :, hs], q_pos]
            oc, lc = expanded_attention_ref(*part, scale=scale)
            o[bs, :, hs], lse[bs, hs] = oc, lc
            if backward:
                gc = expanded_attention_bwd_ref(*part[:5], oc, lc, do[bs, :, hs], q_pos,
                                                scale=scale)
                for i, gi in enumerate(gc):
                    if i == 3:
                        grads[3][bs] += gi
                    else:
                        grads[i][bs, :, hs] = gi
                del gc
            del oc, lc
    return o, lse, grads


def expanded_registers(sources=None) -> dict:
    """:func:`ptxas_report` of B7's kernels, by name, from the build logs of
    both sources (``sources``, or the library's two)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.expanded_attention import backward, kernel

    def name_in(line):
        found = re.search(r"(exp_fwd_bf16|exp_fwd_f32|exp_bwd_prep|exp_dkdv_bf16|exp_dq_bf16|"
                          r"exp_dkdv_f32|exp_dq_f32|exp_rope_reduce)(I(\w+?)EEv)?", line)
        if not found:
            return None
        if found[1] in ("exp_bwd_prep", "exp_rope_reduce"):
            return f"{found[1]}<{'bf16' if 'bfloat16' in line else 'f32'}>"
        return found[1]

    return ptxas_report([build.build_log(s) for s in sources or (kernel.SOURCE, backward.SOURCE)],
                        name_in)


def expanded_check(label, B, S, N, nope, rope, dv, dname, kind, seed) -> tuple:
    """One case: B7's forward (with its LSE) and backward against the plain
    version (float32 from the same inputs: bf16 to float32 loses nothing),
    each run twice for the same bits.  Returns the largest ratio to the
    tolerance, the largest |err|, and the (dtype, direction) kernels whose
    wrappers counted their launches."""
    import torch

    from repro_torch.kernels.expanded_attention import backward as b7_bwd
    from repro_torch.kernels.expanded_attention import kernel as b7

    *ten, do, scale = _expanded_inputs(B, S, N, nope, rope, dv, dname, kind, seed)
    copies, fwd0, bwd0 = b7.layout_copies, b7.launches, b7_bwd.launches
    with torch.no_grad():
        o, lse = b7.attend(*ten, scale=scale, with_lse=True)
        grads = b7_bwd.expanded_attention_bwd(*ten[:5], o, lse, do, ten[5], scale=scale)
        o2, lse2 = b7.attend(*ten, scale=scale, with_lse=True)
        grads2 = b7_bwd.expanded_attention_bwd(*ten[:5], o, lse, do, ten[5], scale=scale)
    torch.cuda.synchronize()
    same = torch.equal(o, o2) and torch.equal(lse, lse2) and all(
        torch.equal(a, b) for a, b in zip(grads, grads2))
    if not same:
        fail(f"B7 at {label} ({dname}): two calls on the same inputs differ")
    if b7.layout_copies != copies:
        fail(f"B7 at {label}: the model's layouts took {b7.layout_copies - copies} layout copies")
    launched = {(dname, way) for way, n in (("forward", b7.launches - fwd0),
                                            ("backward", b7_bwd.launches - bwd0)) if n == 2}
    del o2, lse2, grads2
    ro, rl, rg = expanded_plain([t.float() for t in ten[:5]] + [ten[5]], do.float(), scale)
    ratios = {"o": decode_ratio(o, ro, dname)}
    ratios["lse"] = (lse - rl).abs().max().item() / (1e-4 + 1e-4 * rl.abs().max().item())
    if kind == "mixed":          # a fully masked row's LSE is -1e30 + log T: compare the rest
        live = (ten[5] >= 0)[None, None].expand_as(rl)
        ratios["lse"] = ((lse - rl).abs()[live].max().item()
                         / (1e-4 + 1e-4 * rl[live].abs().max().item()))
    atol, rtol = EXPANDED_GRAD_TOL[dname]
    for name, got, ref in zip(EXPANDED_GRADS, grads, rg):
        scale_ref = max(ref.abs().max().item(), 1.0) if dname == "bfloat16" else 1.0
        ratios[name] = ratio(got, ref, atol * scale_ref, rtol)
    worst = max(ratios.values())
    ok = math.isfinite(worst) and worst <= 1.0
    err = max([(o.float() - ro).abs().max().item()]
              + [(a.float() - b).abs().max().item() for a, b in zip(grads, rg)])
    say(f"  {dname:8s} {label}: B={B} S={S} N={N} nope={nope} rope={rope} v={dv} q_pos {kind} | "
        + ", ".join(f"{k} {v:.2f}" for k, v in ratios.items())
        + f" of tolerance | max_abs_err o {(o.float() - ro).abs().max().item():.3e} | twice: "
          f"the same bits | {'ok' if ok else 'FAIL'}")
    del ten, do, o, lse, grads, ro, rl, rg
    torch.cuda.empty_cache()
    return (worst if ok else float("inf")), err, launched


def expanded_cases(cases=EXPANDED_CASES) -> tuple[list, float, list, set]:
    """Every case of ``cases`` (:func:`expanded_check`): the labels of those
    outside their tolerance, the worst ratio, each case's max |err|, and the
    (dtype, direction) kernels launched."""
    failed, worst, errs, launched = [], 0.0, [], set()
    for i, case in enumerate(cases):
        r, err, ran = expanded_check(*case, seed=700 + i)
        errs.append(err)
        launched |= ran
        if not r <= 1.0:
            failed.append(case[0])
        worst = max(worst, r)
    return failed, worst, errs, launched


def phase_expanded_kernel() -> dict:
    import torch

    from repro_torch.kernels.expanded_attention import kernel as b7

    say("== phase 3d: expanded_attention (B7) forward and backward vs the plain version "
        "(float32 from the same inputs) at 19h's shape, a 16x16 device's train_4k share, "
        "ragged and short lengths, a q_pos that is not arange and the smoke widths "
        f"(tolerance: o B3's; gradients f32 {EXPANDED_GRAD_TOL['float32']}, bf16 rtol 2^-7 and "
        "atol 2^-7 of max(the gradient's largest |ref|, 1))")
    ptxas = expanded_registers()
    for name, rep in sorted(ptxas.items()):
        say(f"  ptxas {name}: {rep.get('registers')} registers, spills (stores, loads) "
            f"{rep.get('spills')}{', wgmma serialized' if rep.get('serialized') else ''}")
    bad = [name for name, rep in ptxas.items()
           if rep.get("spills") != (0, 0) or rep.get("serialized")]
    if bad or len(ptxas) < 10:
        fail(f"B7's kernels spill registers or have their wgmma serialized ({bad}), or ptxas "
             f"reported {len(ptxas)} of its 10 kernels")
    failed, worst, errs, launched = expanded_cases()
    if failed:
        fail(f"B7 disagrees with its plain version at {failed}")
    missing = sorted(set(b7.INSTANCES) - launched)
    if missing:
        fail(f"phase 3d launched no {missing}")
    say(f"  {len(EXPANDED_CASES)} cases within tolerance, each twice with the same bits, every "
        f"kernel of the library launched (worst at {worst:.2f} of its tolerance)")
    record = expanded_time(*EXPANDED_CASES[EXPANDED_TIMED[0]])
    record["train_4k_share"] = expanded_time(*EXPANDED_CASES[EXPANDED_TIMED[1]])
    # the largest |kernel - plain| over o and the five gradients at 19h's shape
    record["max_abs_err"] = errs[EXPANDED_TIMED[0]]
    record["max_abs_err_by_case"] = dict(zip((c[0] for c in EXPANDED_CASES), errs))
    record["ptxas"] = ptxas
    return record


def expanded_library(ten, do, scale) -> tuple[dict, dict]:
    """B7's library yardstick: ``F.scaled_dot_product_attention`` over q =
    [q_nope | q_rope], k = [k_nope | k_rope broadcast to the N heads] and v,
    (B, N, S, ·), ``is_causal`` (the model's q_pos is arange), under each
    fused backend: forward, and forward + backward through autograd.
    Returns the calls that ran by "BACKEND" and "BACKEND+bwd", and the
    refusals with each backend's reasons."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q_nope, q_rope, k_nope, k_rope, v, _ = ten
    N = q_nope.shape[2]
    q = torch.cat([q_nope, q_rope], -1).transpose(1, 2)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(-1, -1, N, -1)], -1).transpose(1, 2)
    vt, dot = v.transpose(1, 2), do.transpose(1, 2)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, vt)]
    ran, refused = {}, {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        def fwd(backend=backend):
            with sdpa_kernel([backend]), torch.no_grad():
                return F.scaled_dot_product_attention(q, k, vt, is_causal=True, scale=scale)

        def both(backend=backend):
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=scale)
                return torch.autograd.grad(out, leaves, dot)

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                fwd()
                both()
                torch.cuda.synchronize()
                ran[backend.name], ran[backend.name + "+bwd"] = fwd, both
            except RuntimeError as e:
                refused[backend.name] = sdpa_reasons(backend.name, [str(w.message) for w in caught]) \
                    or str(e).splitlines()[0][:300]
    return ran, refused


def expanded_time(label, B, S, N, nope, rope, dv, dname, kind) -> dict:
    """B7 at one of the training paths' shapes: the forward alone and the
    forward + backward, in a CUDA graph and launched from Python, beside
    the plain version (:func:`expanded_plain`, from Python), the library
    (:func:`expanded_library`'s fastest call: a yardstick only, the port
    never calls it) and the bound: the products of the causal half (the
    pairs this run's q_pos makes visible) at the bf16 peak, the forward's
    two and the backward's five (the scores recomputed once, dP, dV, dQ,
    dK: 2.6x the forward), against each input read once and each output
    written once."""
    import torch

    from repro_torch.kernels.expanded_attention import backward as b7_bwd
    from repro_torch.kernels.expanded_attention import kernel as b7

    *ten, do, scale = _expanded_inputs(B, S, N, nope, rope, dv, dname, kind, seed=790 + S)
    T = S
    pairs = int(torch.clamp(ten[5] + 1, 0, T).sum()) * B * N
    fwd_flops = 2.0 * pairs * (nope + rope + dv)
    bwd_flops = 2.0 * pairs * (3 * (nope + rope) + 2 * dv)
    esize = ten[0].element_size()
    inputs = sum(t.numel() for t in ten[:5]) * esize
    out = B * S * N * dv * esize
    fwd_bytes = inputs + out + 4 * B * N * S + 8 * S
    bwd_bytes = inputs + 2 * out + 4 * B * N * S + 8 * S + inputs  # reads, and the five grads

    def forward():
        return b7.attend(*ten, scale=scale, with_lse=True)

    def both():
        o, lse = b7.attend(*ten, scale=scale, with_lse=True)
        return b7_bwd.expanded_attention_bwd(*ten[:5], o, lse, do, ten[5], scale=scale)

    before, before_bwd = b7.launches, b7_bwd.launches
    graphed, eager, plain = {}, {}, {}
    with torch.no_grad():
        for name, fn in (("forward", forward), ("both", both)):
            graphed[name] = graph_ms(fn, 2, 5)
            eager[name] = time_ms(fn, 5)
        # the plain version from Python, a few batch rows and heads at a time
        for name, bwd in (("forward", False), ("both", True)):
            plain[name] = time_ms(lambda bwd=bwd: expanded_plain(ten, do, scale, bwd), 1, warmup=1)
    torch.cuda.empty_cache()
    b7.launches, b7_bwd.launches = before, before_bwd    # timing launches are not a path's
    ran, refused = expanded_library(ten, do, scale)
    lib = {key: time_ms(fn, 5) for key, fn in ran.items()}
    torch.cuda.empty_cache()
    fwd_bound, fwd_by = bound(fwd_flops, fwd_bytes, "bfloat16")
    both_bound, both_by = bound(fwd_flops + bwd_flops, fwd_bytes + bwd_bytes, "bfloat16")
    best_f = min((k for k in lib if not k.endswith("+bwd")), key=lib.get, default=None)
    best_b = min((k for k in lib if k.endswith("+bwd")), key=lib.get, default=None)
    plain_f, plain_b = plain["forward"], plain["both"]

    say(f"-- B7 timing at {label}: q ({B},{S},{N},{nope}+{rope}), v {dv}, {dname}, "
        f"{pairs / B / N:.0f} visible pairs a head | forward: graph {graphed['forward']:.5f} ms, "
        f"eager {eager['forward']:.5f}, plain {plain_f:.5f} (eager, chunked), library "
        + (f"{lib[best_f]:.5f} ({best_f}, eager)" if best_f else "none")
        + f", bound {fwd_bound:.5f} ({fwd_by}, {fwd_flops / 1e12:.4f} TFLOP) at "
          f"{fwd_bound / graphed['forward']:.1%} | forward + backward: graph "
          f"{graphed['both']:.5f} ms, eager {eager['both']:.5f}, plain {plain_b:.5f}, library "
        + (f"{lib[best_b]:.5f} ({best_b}, eager)" if best_b else "none")
        + f", bound {both_bound:.5f} ({both_by}, {(fwd_flops + bwd_flops) / 1e12:.4f} TFLOP) at "
          f"{both_bound / graphed['both']:.1%}")
    for key, why in refused.items():
        say(f"   SDPA {key} refused: {why}")
    del ten, do
    torch.cuda.empty_cache()
    return dict(shape=[B, S, N, nope, rope, dv], ms=graphed["both"], eager_ms=eager["both"],
                forward_ms=graphed["forward"], forward_eager_ms=eager["forward"],
                plain_ms=plain_b, plain_forward_ms=plain_f,
                library_ms=lib[best_b] if best_b else None, library_backend=best_b,
                library_forward_ms=lib[best_f] if best_f else None,
                library_ms_by_call=lib, library_refusals=refused,
                bound_ms=both_bound, bound_by=both_by, forward_bound_ms=fwd_bound,
                flops=fwd_flops + bwd_flops, forward_flops=fwd_flops)


# ---------------------------------------------------------------------------
# phase 3e: RMSNorm (B8) and rotary embeddings (B9)
# ---------------------------------------------------------------------------

# B8's cases: (label, leading shape, width, row stride in elements (None: the
# width), dtype, offset, the base's offset in elements).  19c's and 19h's
# rows, MLA's c_kv read in its 576-wide rows, the qk-norm's rows of a head,
# the decode rows, the float32 widths of phases 5, 10, 15 and 19d, odd widths
# in both layouts, a base 16 bytes off (vector loads) and 2 bytes off
# (element loads), a row of one, and rows wider than the backward's register
# plan (rms_bwd_kernel_wide) in vectors and elements
NORM_CASES = [
    ("19c apply_norm, phi4-mini", (2, 512), 3072, None, "bfloat16", 1.0, 0),
    ("19h apply_norm, deepseek-v2", (2, 4096), 5120, None, "bfloat16", 1.0, 0),
    ("19h kv_norm, c_kv in rows of 576", (2, 4096), 512, 576, "bfloat16", 0.0, 0),
    ("qk-norm, rows of a head of 128", (2, 512, 24), 128, None, "bfloat16", 0.0, 0),
    ("phi4-mini decode, 4 slots", (4, 1), 3072, None, "bfloat16", 1.0, 0),
    ("deepseek-v2 decode kv_norm", (4, 1), 512, 576, "bfloat16", 0.0, 0),
    ("phi4-mini width, float32", (2, 48), 3072, None, "float32", 1.0, 0),
    ("smoke width 192, float32", (2, 48), 192, None, "float32", 1.0, 0),
    ("deepseek-v2 smoke kv_norm, rows of 48, float32", (2, 48), 32, 48, "float32", 0.0, 0),
    ("odd width 77, a warp a row", (3, 5), 77, None, "bfloat16", 1.0, 0),
    ("odd width 1031, a block a row", (3, 5), 1031, None, "bfloat16", 1.0, 0),
    ("odd width 1031, float32", (3, 5), 1031, None, "float32", 0.0, 0),
    ("base 16 bytes off", (64,), 3072, None, "bfloat16", 1.0, 8),
    ("base 2 bytes off", (64,), 3072, None, "bfloat16", 1.0, 1),
    ("base 16 bytes off, float32", (64,), 1024, None, "float32", 1.0, 4),
    ("a row of one", (5,), 1, None, "float32", 1.0, 0),
    ("beyond the register plan, float32", (2, 48), 5120, None, "float32", 1.0, 0),
    ("beyond the register plan, odd width 9001", (3, 5), 9001, None, "bfloat16", 0.0, 0),
]
# the cases timed: 19c's rows and 19h's
NORM_TIMED = (0, 1)
NORM_EPS = 1e-6
# B8 against its plain version computed in float32 from the same inputs.
# float32: y and rstd within NORM_RTOL relative, dx within NORM_RTOL of its
# row's largest |rstd * dy * (offset + scale)| (dx is the difference of two
# terms of that size, so an element near 0 keeps no relative precision).
# bf16: y within one bf16 ulp of the plain version's float32 value (the
# kernel's float32 value differs from it by the row sum's order and is
# rounded once); dx within one ulp plus the float32 rule.  dscale (float32, the rows summed in another
# order) within NORM_DSCALE_TOL of its largest magnitude.
NORM_RTOL = 1e-5
NORM_DSCALE_TOL = 1e-4
# B9's cases: (label, B, S, heads, head_dim, layout, dtype, positions).
# layout: None (contiguous), ("heads", width, start) a slice of wider heads,
# ("rows", width, start) a slice of wider rows with one head, ("off", n) the
# base n elements off; positions "arange" or "offsets" (each row from its own
# offset).  19c's q and k, 19h's q_rope and k_rope where they lie, zamba2's
# hd 80, a served decode, the smoke widths at float32, an odd half (element
# loads), a base 16 bytes off
ROPE_CASES = [
    ("19c q, phi4-mini", 2, 512, 24, 128, None, "bfloat16", "arange"),
    ("19c k, phi4-mini", 2, 512, 8, 128, None, "bfloat16", "arange"),
    ("19h q_rope in 192-wide heads", 2, 4096, 128, 64, ("heads", 192, 128), "bfloat16", "arange"),
    ("19h k_rope in 576-wide rows", 2, 4096, 1, 64, ("rows", 576, 512), "bfloat16", "arange"),
    ("zamba2 hd 80", 4, 512, 32, 80, None, "bfloat16", "arange"),
    ("phi4-mini decode, S 1", 4, 1, 24, 128, None, "bfloat16", "offsets"),
    ("deepseek-v2 decode q_rope", 4, 1, 128, 64, ("heads", 192, 128), "bfloat16", "offsets"),
    ("smoke hd 32, float32", 2, 48, 6, 32, None, "float32", "arange"),
    ("deepseek-v2 smoke q_rope, float32", 2, 48, 4, 16, ("heads", 48, 32), "float32", "arange"),
    ("odd half 3", 2, 7, 3, 6, None, "bfloat16", "offsets"),
    ("base 16 bytes off", 2, 64, 8, 128, ("off", 8), "bfloat16", "arange"),
]
# the cases timed: 19c's q and 19h's q_rope
ROPE_TIMED = (0, 2)
ROPE_THETA = 10000.0


def bf16_ulp(v):
    """One bf16 ulp at each |v| of a float32 tensor (the smallest normal's
    at 0)."""
    import torch

    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def norm_inputs(lead, width, stride, dname, offset, base, seed):
    """x (lead + (width,)) read from rows ``stride`` apart starting ``base``
    elements into its buffer, scale (float32) and dy, drawn on the card."""
    import torch

    dtype = getattr(torch, dname)
    rows, st = math.prod(lead), stride or width
    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.randn(base + rows * st, generator=g, device="cuda").to(dtype)
    x = buf[base:].view(rows, st)[:, :width].view(*lead, width)
    scale = torch.randn(width, generator=g, device="cuda") * 0.1 + (1.0 - offset)
    dy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
    return x, scale, dy


def norm_check(label, lead, width, stride, dname, offset, base, seed, plan_check: bool = True
               ) -> tuple[float, float]:
    """B8's forward and backward against the plain versions in float32, each
    run twice for the same bits; fails on a disagreement, and (with
    ``plan_check``) where the backward's plan assumed another residency
    than the card's.  Returns the worst share of the tolerance and the
    largest |y - plain|."""
    import torch

    from repro_torch.kernels.rms_norm import backward as b8b
    from repro_torch.kernels.rms_norm import kernel as b8
    from repro_torch.kernels.rms_norm.ref import rms_norm_bwd_ref, rms_norm_ref

    x, scale, dy = norm_inputs(lead, width, stride, dname, offset, base, seed)
    y, rstd = b8.rms_norm(x, scale, NORM_EPS, offset)
    dx, ds = b8b.rms_norm_bwd(x, scale, rstd, dy, offset)
    again = b8.rms_norm(x, scale, NORM_EPS, offset) + b8b.rms_norm_bwd(x, scale, rstd, dy, offset)
    same = all(torch.equal(a, b) for a, b in zip((y, rstd, dx, ds), again))
    want_y, want_r = rms_norm_ref(x.float(), scale, NORM_EPS, offset)
    want_dx, want_ds = rms_norm_bwd_ref(x.float(), scale, want_r, dy.float(), offset)
    terms = want_r[..., None] * dy.float() * (offset + scale)
    row = NORM_RTOL * terms.abs().amax(dim=-1, keepdim=True) + 1e-30
    if dname == "float32":
        y_tol, dx_tol = NORM_RTOL * want_y.abs() + 1e-30, row
    else:
        y_tol, dx_tol = bf16_ulp(want_y), bf16_ulp(want_dx) + row
    shares = {
        "y": ((y.float() - want_y).abs() / y_tol).max().item(),
        "rstd": ((rstd - want_r).abs() / (NORM_RTOL * want_r.abs())).max().item(),
        "dx": ((dx.float() - want_dx).abs() / dx_tol).max().item(),
        "dscale": ((ds - want_ds).abs().max() / (NORM_DSCALE_TOL * want_ds.abs().max() + 1e-30)
                   ).item(),
    }
    worst = max(shares.values())
    err = (y.float() - want_y).abs().max().item()
    rows, es = x.numel() // width, x.element_size()
    vec = bool(b8.aligned(b8.rows_of(x), b8.rows_of(dy)))
    plan = b8.choose_backward(rows, width, es, vec)
    occupancy, assumed = bwd_occupancy(plan, es, vec), b8.blocks_an_sm(plan, es, vec)
    say(f"  {label}: x {tuple(x.shape)} {dname} row stride {stride or width}, base +{base}, "
        f"offset {offset}, {b8.choose_launch(rows, width)}, backward {plan} (vector loads {vec}; "
        f"partial rows {plan.parts * width * 4} B written and read, {bwd_bytes(rows, width, es)}"
        f" B bound; the card holds (blocks an SM, clusters) {occupancy}, the plan assumed "
        f"{assumed} blocks an SM); share of the tolerance "
        + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
        + f"; max |y - plain| {err:.3e}; same bits twice: {same}")
    if not (worst <= 1.0 and same):
        fail(f"B8 disagrees with its plain version at {label} ({shares}, same bits {same})")
    if plan_check and (occupancy[0] != assumed or plan.grid > occupancy[1] * plan.cluster):
        fail(f"B8's backward plan at {label} assumed {assumed} blocks an SM and a grid of "
             f"{plan.grid} in clusters of {plan.cluster}; the card holds {occupancy[0]} blocks an "
             f"SM and {occupancy[1]} clusters at once (kernel.REGISTERS or CLUSTER_SMS is stale)")
    return worst, err


def rope_inputs(B, S, H, hd, layout, dname, positions, seed):
    """x (B, S, H, hd) in ``layout`` and the tables of ``positions``, on the
    card."""
    import torch

    from repro_torch.kernels.rotary.ref import rope_tables

    dtype = getattr(torch, dname)
    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    if layout is None:
        x = draw(B, S, H, hd)
    elif layout[0] == "heads":
        x = draw(B, S, H, layout[1])[..., layout[2]:layout[2] + hd]
    elif layout[0] == "rows":
        x = draw(B, S, layout[1])[..., layout[2]:layout[2] + hd][:, :, None, :]
    else:
        x = draw(layout[1] + B * S * H * hd)[layout[1]:].view(B, S, H, hd)
    pos = torch.arange(S, device="cuda").expand(B, S)
    if positions == "offsets":
        pos = pos + torch.randint(0, 1000, (B, 1), generator=g, device="cuda")
    cos, sin = rope_tables(pos, hd, ROPE_THETA)
    return x, cos, sin


def rope_check(label, B, S, H, hd, layout, dname, positions, seed) -> None:
    """B9 forward and backward (``negate``) against its plain version on the
    card: the same bits, or the run fails."""
    import torch

    from repro_torch.kernels.rotary import kernel as b9
    from repro_torch.kernels.rotary.ref import rotary_ref

    x, cos, sin = rope_inputs(B, S, H, hd, layout, dname, positions, seed)
    copies = b9.layout_copies
    diff = {}
    for negate in (False, True):
        got = b9.rotary(x, cos, sin, negate=negate)
        want = rotary_ref(x, cos, sin, negate)
        diff[negate] = int((got != want).sum())
    say(f"  {label}: x {tuple(x.shape)} {dname} strides {x.stride()}, vector loads "
        f"{bool(b9.vectors(x, cos, sin))}; elements that differ from the plain version: "
        f"forward {diff[False]}, backward {diff[True]}")
    if any(diff.values()) or b9.layout_copies != copies:
        fail(f"B9 is not bit-identical to its plain version at {label} ({diff}) or copied its "
             f"input ({b9.layout_copies - copies})")


def bwd_bytes(rows: int, width: int, elem_bytes: int) -> int:
    """The bytes B8's backward must move: x and dy read and dx written once,
    rstd read, scale read and dscale written."""
    return rows * width * elem_bytes * 3 + rows * 4 + width * 4 * 2


def bwd_occupancy(plan, elem_bytes: int, vec: bool = True) -> tuple[int, int]:
    """The card's blocks an SM and clusters at once for the backward's rows
    kernel under ``plan`` (``rms_bwd_occupancy``)."""
    import ctypes

    import torch

    from repro_torch.kernels.rms_norm import kernel as b8

    out = (ctypes.c_int * 2)()
    b8.raise_on(b8.library(torch.device("cuda")).rms_bwd_occupancy(
        int(elem_bytes == 2), int(vec), plan.items, plan.stages, plan.threads, plan.smem,
        plan.cluster, out), "rms_bwd_occupancy")
    return out[0], out[1]


def norm_time(label, lead, width, stride, dname, offset, base) -> dict:
    """B8's forward and backward at one case, in a CUDA graph and launched
    from Python, beside the plain versions, the bytes bound and one PyTorch
    call each way (yardsticks; the port never calls them): ``F.rms_norm``
    and ``aten._fused_rms_norm_backward`` on a weight in x's dtype with its
    own ``_fused_rms_norm``'s rstd."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rms_norm import backward as b8b
    from repro_torch.kernels.rms_norm import kernel as b8
    from repro_torch.kernels.rms_norm.ref import rms_norm_bwd_ref, rms_norm_ref

    x, scale, dy = norm_inputs(lead, width, stride, dname, offset, base, seed=7)
    rows, es = x.numel() // width, x.element_size()
    rstd = b8.rms_norm(x, scale, NORM_EPS, offset)[1]
    weight = offset + scale
    try:
        F.rms_norm(x, (width,), weight, NORM_EPS)
        library = "F.rms_norm, float32 weight"
    except RuntimeError:
        weight = weight.to(x.dtype)
        library = f"F.rms_norm, {dname} weight"
    fwd_bytes = rows * width * es * 2 + rows * 4 + width * 4
    nbytes = bwd_bytes(rows, width, es)
    fwd_bound, fwd_by = bound(5.0 * rows * width, fwd_bytes, "float32")
    bwd_bound, bwd_by = bound(10.0 * rows * width, nbytes, "float32")
    plan = b8.choose_backward(rows, width, es)
    wl = (offset + scale).to(x.dtype)
    try:
        rl = torch.ops.aten._fused_rms_norm(x, [width], wl, NORM_EPS)[1]
        bwd_library = f"aten._fused_rms_norm_backward, {dname} weight"
        bwd_library_ms = graph_ms(lambda: torch.ops.aten._fused_rms_norm_backward(
            dy, x, [width], rl, wl, [True, True]))
    except (AttributeError, RuntimeError, NotImplementedError) as e:
        bwd_library = f"aten._fused_rms_norm_backward absent in torch {torch.__version__}: " \
                      f"{type(e).__name__}"
        bwd_library_ms = None
    rec = dict(
        shape=f"{tuple(x.shape)} {dname}",
        ms=graph_ms(lambda: b8.rms_norm(x, scale, NORM_EPS, offset)),
        eager_ms=time_ms(lambda: b8.rms_norm(x, scale, NORM_EPS, offset), 20),
        plain_ms=graph_ms(lambda: rms_norm_ref(x, scale, NORM_EPS, offset)),
        bound_ms=fwd_bound, bound_by=fwd_by, bytes=fwd_bytes,
        library_ms=graph_ms(lambda: F.rms_norm(x, (width,), weight, NORM_EPS)), library=library,
        bwd_ms=graph_ms(lambda: b8b.rms_norm_bwd(x, scale, rstd, dy, offset)),
        bwd_eager_ms=time_ms(lambda: b8b.rms_norm_bwd(x, scale, rstd, dy, offset), 20),
        bwd_plain_ms=graph_ms(lambda: rms_norm_bwd_ref(x, scale, rstd, dy, offset)),
        bwd_bound_ms=bwd_bound, bwd_bound_by=bwd_by, bwd_bytes=nbytes,
        bwd_library_ms=bwd_library_ms, bwd_library=bwd_library,
        bwd_partial_bytes=plan.parts * width * 4 * 2, bwd_occupancy=bwd_occupancy(plan, es),
        launch=str(b8.choose_launch(rows, width)), bwd_launch=str(plan))
    say(f"  {label} {rec['shape']}: forward {rec['ms']:.5f} ms in a graph ({rec['eager_ms']:.5f} "
        f"from Python), {rec['bound_ms'] / rec['ms']:.1%} of its {rec['bound_ms']:.5f} ms bound "
        f"({fwd_bytes / 1e6:.3f} MB), plain {rec['plain_ms']:.5f}, {library} "
        f"{rec['library_ms']:.5f}; backward {rec['bwd_ms']:.5f} ({rec['bwd_eager_ms']:.5f} from "
        f"Python), {rec['bwd_bound_ms'] / rec['bwd_ms']:.1%} of its {rec['bwd_bound_ms']:.5f} ms "
        f"bound ({nbytes / 1e6:.3f} MB; partial rows {rec['bwd_partial_bytes'] / 1e6:.3f} MB "
        f"written and read), plain {rec['bwd_plain_ms']:.5f}, {bwd_library} "
        f"{'not timed' if bwd_library_ms is None else f'{bwd_library_ms:.5f}'}; "
        f"{rec['launch']}, backward {rec['bwd_launch']}, the card holds (blocks an SM, clusters) "
        f"{rec['bwd_occupancy']} of it")
    return rec


def rope_time(label, B, S, H, hd, layout, dname, positions) -> dict:
    """B9 at one case, in a CUDA graph and launched from Python, beside the
    plain version and the bytes bound (torch has no rotary call)."""
    from repro_torch.kernels.rotary import kernel as b9
    from repro_torch.kernels.rotary.ref import rotary_ref

    x, cos, sin = rope_inputs(B, S, H, hd, layout, dname, positions, seed=7)
    nbytes = x.numel() * x.element_size() * 2 + B * S * (hd // 2) * 4 * 2
    b, by = bound(6.0 * x.numel() / 2, nbytes, "float32")
    rec = dict(shape=f"{tuple(x.shape)} {dname}", ms=graph_ms(lambda: b9.rotary(x, cos, sin)),
               eager_ms=time_ms(lambda: b9.rotary(x, cos, sin), 20),
               plain_ms=graph_ms(lambda: rotary_ref(x, cos, sin)), bound_ms=b, bound_by=by,
               bytes=nbytes, library_ms=None)
    say(f"  {label} {rec['shape']}: {rec['ms']:.5f} ms in a graph ({rec['eager_ms']:.5f} from "
        f"Python), {b / rec['ms']:.1%} of its {b:.5f} ms bound ({nbytes / 1e6:.3f} MB), plain "
        f"{rec['plain_ms']:.5f}")
    return rec


def norm_rope_kernel(line: str):
    """The B8 or B9 kernel a line of ptxas's report names (its template
    arguments mangled), or None."""
    found = re.search(r"(rms_fwd_kernel|rms_bwd_kernel_wide|rms_bwd_kernel_tma|rms_bwd_kernel|"
                      r"rms_dscale_kernel|rotary_kernel)(I\w+?EEv|v)?", line)
    return found and found[1] + (found[2] or "")


def norm_rope_registers() -> dict:
    """Registers and spills of B8's and B9's kernels, from ptxas's reports."""
    from repro_torch.kernels import build
    from repro_torch.kernels.rms_norm import kernel as b8
    from repro_torch.kernels.rotary import kernel as b9

    return ptxas_report([build.build_log(b8.SOURCE), build.build_log(b9.SOURCE)],
                        norm_rope_kernel)


def phase_norm_rope() -> dict:
    """Phase 3e: B8 and B9 against their plain versions at every shape the
    paths give them, then timed."""
    say("== phase 3e: rms_norm (B8) forward and backward and rotary (B9) both ways vs the "
        f"plain versions (B8: float32 {NORM_RTOL} relative, dx {NORM_RTOL} of its row's "
        "largest rstd * dy * (offset + scale); bf16 one ulp of the plain float32 value, dx "
        "plus the float32 rule; dscale "
        f"{NORM_DSCALE_TOL} of its largest; B9: the same bits)")
    for name, rep in sorted(norm_rope_registers().items()):
        say(f"  ptxas {name}: {rep.get('registers')} registers, spills (stores, loads) "
            f"{rep.get('spills')}")
    from repro_torch.kernels.rms_norm import kernel as b8

    copies = b8.layout_copies
    results = [norm_check(*case, seed=i) for i, case in enumerate(NORM_CASES)]
    if b8.layout_copies != copies:
        fail(f"B8 copied {b8.layout_copies - copies} inputs it should read in place")
    for i, case in enumerate(ROPE_CASES):
        rope_check(*case, seed=i)
    say(f"  {len(NORM_CASES)} B8 cases within tolerance (worst at "
        f"{max(w for w, _ in results):.3f} of it), {len(ROPE_CASES)} B9 cases bit-identical, "
        "both directions, every case twice with the same bits; no layout copy")
    b8_rec = norm_time(*NORM_CASES[NORM_TIMED[0]])
    b8_rec["deepseek_19h"] = norm_time(*NORM_CASES[NORM_TIMED[1]])
    b8_rec["max_abs_err"] = results[NORM_TIMED[0]][1]
    b9_rec = rope_time(*ROPE_CASES[ROPE_TIMED[0]])
    b9_rec["deepseek_19h"] = rope_time(*ROPE_CASES[ROPE_TIMED[1]])
    b9_rec["max_abs_err"] = 0.0
    release()
    return dict(b8=b8_rec, b9=b9_rec)


# ---------------------------------------------------------------------------
# B8 and B9 in the paths' replays, and the training step's element-wise
# kernels by the chain that launched them
# ---------------------------------------------------------------------------

# B8's and B9's kernels, by a substring of their names (B8_BWD names the
# backward's rows kernels, rms_bwd_kernel, rms_bwd_kernel_tma and
# rms_bwd_kernel_wide; B8_DSCALE its finish, rms_dscale_kernel)
B8_FWD, B8_BWD, B8_DSCALE, B9_KERNEL = ("rms_fwd_kernel", "rms_bwd_kernel", "rms_dscale_kernel",
                                        "rotary_kernel")
B8_BWD_KERNELS = 2              # a backward call: one B8_BWD and one B8_DSCALE
# the profiled replays check_norm_rope held, and by kernel module (B8's
# forward, B8's backward: B8_BWD_KERNELS kernels a call, B9) the kernels the
# profiler saw in them and the calls they replay
NORM_ROPE_REPLAYS = {"replays": 0, **{k: {"kernels": 0, "calls": 0}
                                      for k in ("rms_norm", "rms_norm_bwd", "rotary")}}


def norm_rope_calls(cfg) -> tuple[int, int]:
    """B8's and B9's calls in one forward of ``cfg``, a decoder whose every
    layer attends: two RMSNorms a layer (four with gemma2's post-norms) and
    the final one, MLA's kv_norm, the qk-norm's two; RoPE on q and k."""
    L = cfg.n_layers
    norms = ((4 if cfg.post_attn_norm else 2) * L + 1) if cfg.norm == "rmsnorm" else 0
    norms += L * (cfg.mla is not None) + 2 * L * bool(cfg.qk_norm)
    return norms, 2 * L


def norm_rope_launches() -> dict:
    """B8's forward and backward and B9's wrapper counts, by kernel name."""
    from repro_torch.kernels.rms_norm import backward as b8_bwd
    from repro_torch.kernels.rms_norm import kernel as b8
    from repro_torch.kernels.rotary import kernel as b9

    return {B8_FWD: b8.launches, B8_BWD: b8_bwd.launches, B9_KERNEL: b9.launches}


@contextlib.contextmanager
def capture_counts(step_fn, into: dict):
    """B8's and B9's launches that sealing ``step_fn`` records into its CUDA
    graph, into ``into``: the seal's less its warm-up's (one call of
    ``step_fn.loss_and_grads`` before the capture)."""
    inner, warm = step_fn.loss_and_grads, {}

    def counted(*args):
        before = norm_rope_launches()
        out = inner(*args)
        warm.update({k: v - before[k] for k, v in norm_rope_launches().items()})
        return out

    start = norm_rope_launches()
    step_fn.loss_and_grads = counted
    try:
        yield into
    finally:
        step_fn.loss_and_grads = inner
    into.update({k: v - start[k] - warm.get(k, 0) for k, v in norm_rope_launches().items()})


def check_norm_rope(rows, cfg, label: str, backward: bool = False, again=None,
                    captured: dict | None = None) -> None:
    """Fails unless a profiled replay's kernels (``rows``) hold B8's and B9's
    kernels as often as ``cfg``'s layers give: a B8 forward a norm, with
    ``backward`` also its ``B8_BWD_KERNELS`` backward kernels (a B8_BWD
    and a B8_DSCALE), and a B9 a rotation, twice
    with ``backward``; adds them to ``NORM_ROPE_REPLAYS``.  A session that
    recorded fewer of them is read again with ``again`` (a call of the
    replay), up to three times, from the second of two calls in one
    session (:func:`second_call_kernels`), each kernel's count the most any
    session recorded: a session can lose the records of its first kernels
    (a replay's second kernel is its first norm), never add one.  With
    ``captured`` (the wrappers' launches the capture recorded into the
    replayed graph, :func:`capture_counts`), those must be the layers'
    count, and a profile that still records fewer is reported, not failed:
    19c's replay has come back with 64 of its 65 norms' forward kernels in
    every session of a run while the capture held 65 and the replays gave
    the eager steps' bits."""
    norms, ropes = norm_rope_calls(cfg)
    n = 1 + backward
    want = {B8_FWD: norms, B8_BWD: norms * backward, B8_DSCALE: norms * backward,
            B9_KERNEL: ropes * n}

    def counts(rows):
        return {k: sum(c for _, c, key in rows if k in key) for k in want}

    got = counts(rows)
    if captured is not None:
        want_captured = {B8_FWD: norms, B8_BWD: norms * backward, B9_KERNEL: ropes * n}
        say(f"  {label}: B8's and B9's launches the capture recorded {captured} (want "
            f"{want_captured})")
        if captured != want_captured:
            fail(f"{label}: the capture recorded B8's and B9's launches {captured}, want "
                 f"{want_captured}")
    for _ in range(3 if again else 0):
        if got == want or any(got[k] > want[k] for k in want):
            break
        say(f"    ({label}: the profiler recorded B8's and B9's kernels {got} of {want}: "
            "profiling again)")
        more = counts(by_kernel(second_call_kernels(again)))
        got = {k: max(v, more[k]) for k, v in got.items()}
    us = {k: sum(t for t, _, key in rows if k in key) for k in got}
    total = sum(t for t, _, _ in rows)
    NORM_ROPE_REPLAYS["replays"] += 1
    for name, kernels, calls in (("rms_norm", got[B8_FWD], norms),
                                 ("rms_norm_bwd", got[B8_BWD] + got[B8_DSCALE], norms * backward),
                                 ("rotary", got[B9_KERNEL], ropes * n)):
        NORM_ROPE_REPLAYS[name]["kernels"] += kernels
        NORM_ROPE_REPLAYS[name]["calls"] += calls
    say(f"  {label}: B8 " + ", ".join(f"{k} x{got[k]} {us[k] / 1e3:.3f} ms" for k in
                                        (B8_FWD, B8_BWD, B8_DSCALE))
        + f"; B9 {B9_KERNEL} x{got[B9_KERNEL]} {us[B9_KERNEL] / 1e3:.3f} ms; together "
        f"{sum(us.values()) / total:.1%} of the replay's kernel time")
    short = all(got[k] <= want[k] for k in want) and got != want
    if short and captured is not None:
        say(f"  {label}: the profiler recorded {got} of the {want} kernels the capture holds")
    elif got != want:
        fail(f"{label}: a replay ran B8's and B9's kernels {got}, want {want} ({norms} norms "
             f"and {ropes} rotations a forward)")


# the chains a training step's element-wise kernels are put under: each the
# layer function whose calls (and, through autograd, whose backward) launch
# them; the kernels no chain launched are "other: residual and gradient
# sums, the autograd engine's accumulations"
# (``_rms``: the name of the qk-norm's and kv_norm's rows in trees before B8)
CHAIN_FUNCTIONS = (("norm", "layers", "apply_norm"), ("norm", "layers", "_rms_scaled"),
                   ("norm", "layers", "_rms"), ("rope", "layers", "apply_rope"),
                   ("swiglu (dense FFN)", "layers", "apply_ffn"),
                   ("MoE: router, dispatch, combine, activation", "moe", "apply_moe"),
                   ("attention: projections' reshapes, masks", "layers", "attention"),
                   ("attention: projections' reshapes, masks", "mla", "mla_attention"),
                   ("logits: the float32 cast, the soft-cap", "layers", "unembed"),
                   ("embedding and its gradient", "layers", "embed_tokens"),
                   ("loss", "train_lib", "cross_entropy"),
                   ("optimizer: clip and AdamW", "adamw", "adamw_update"))
# kernels named here are not element-wise: the port's kernels (and cuBLAS's
# products, GEMM_NAMES)
PORT_KERNEL_NAMES = ("flash_", "bwd_dot", "bwd_dkdv", "bwd_dq", "stream_pack", "adamw_",
                     "ce_partials", "ce_backward", "exp_", "rms_", "rotary_", "spin_kernel")


@contextlib.contextmanager
def chain_scopes():
    """Each function of ``CHAIN_FUNCTIONS`` (those the tree has) wrapped, in
    every module of the port that holds it, in a ``record_function`` range
    named ``chain:<chain>``."""
    import functools

    import torch

    from repro_torch.models import layers, mla, moe
    from repro_torch.optim import adamw
    from repro_torch.training import train_lib

    mods = dict(layers=layers, mla=mla, moe=moe, train_lib=train_lib, adamw=adamw)
    swaps = []
    for chain, mod, name in CHAIN_FUNCTIONS:
        fn = getattr(mods[mod], name, None)
        if fn is None:
            continue

        def scoped(*a, _fn=fn, _chain=chain, **kw):
            with torch.profiler.record_function(f"chain:{_chain}"):
                return _fn(*a, **kw)

        functools.update_wrapper(scoped, fn)
        for module in list(sys.modules.values()):
            if getattr(module, "__name__", "").startswith("repro_torch"):
                for attr, value in list(vars(module).items()):
                    if value is fn:
                        swaps.append((module, attr, fn))
                        setattr(module, attr, scoped)
    try:
        yield
    finally:
        for module, attr, fn in reversed(swaps):
            setattr(module, attr, fn)


def _chain_of(evt, by_seq: dict) -> str:
    """The chain of the innermost ``chain:`` range around ``evt``; for an op
    of the backward, that of the forward op whose autograd node it runs
    (by sequence number)."""
    e = evt
    while e is not None:
        if e.name.startswith("chain:"):
            return e.name[len("chain:"):]
        if e.name.startswith("autograd::engine::evaluate_function: "):
            return by_seq.get(e.sequence_nr, "other")
        e = e.cpu_parent
    return "other"


def chain_breakdown(step, label: str, bounds: dict) -> tuple:
    """One call of ``step`` (an eager training step) under the profiler,
    the chains' functions in ranges (:func:`chain_scopes`, which change no
    bit of the step): each device kernel that is not a product or a kernel
    of the port's, by the chain that launched it, ms beside the chain's
    bytes bound (``bounds``: chain -> bytes, from :func:`chain_bytes`), the
    top kernel names of each.  Returns what ``step`` returned and
    {"chains": {chain: {"ms", "kernels", "bound_ms"}}, and the totals}."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    with chain_scopes():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            spin()
            result = step()
            torch.cuda.synchronize()
    events = list(prof.events())
    by_seq = {}
    for e in events:
        if e.sequence_nr is not None and e.sequence_nr >= 0:
            chain = _chain_of(e, {})
            if chain != "other" or e.sequence_nr not in by_seq:
                by_seq[e.sequence_nr] = chain
    chains: dict = collections.defaultdict(lambda: collections.Counter())
    us_by: dict = collections.defaultdict(float)
    linked = 0.0
    for e in events:
        for k in getattr(e, "kernels", []) or []:
            if "spin_kernel" in k.name:
                continue
            linked += k.duration
            if any(w in k.name.lower() for w in GEMM_NAMES + PORT_KERNEL_NAMES):
                continue
            chain = _chain_of(e, by_seq)
            us_by[chain] += k.duration
            chains[chain][k.name] += 1
    # the ranges' own spans on the device's timeline are not kernels
    total = sum(e.time_range.elapsed_us() for e in device_events(prof)
                if not e.name.startswith("chain:"))
    ew = sum(us_by.values())
    say(f"  {label}: an eager step's device kernels {total / 1e3:.3f} ms (of them "
        f"{linked / 1e3:.3f} linked to the torch op that launched them: the rest are the "
        f"port's kernels, launched through ctypes), element-wise {ew / 1e3:.3f} ms, by chain "
        "(ms, kernels, bytes bound ms at 3.35 TB/s):")
    out = {}
    for chain, us in sorted(us_by.items(), key=lambda kv: -kv[1]):
        b = bounds.get(chain)
        b_ms = None if b is None else b / 3.35e12 * 1e3
        n = sum(chains[chain].values())
        out[chain] = dict(ms=us / 1e3, kernels=n, bound_ms=b_ms)
        top = ", ".join(f"{name[:48]} x{c}" for name, c in chains[chain].most_common(3))
        say(f"    {chain}: {us / 1e3:.3f} ms, {n} kernels, bound "
            f"{'not computed' if b_ms is None else f'{b_ms:.3f} ms'}; top: {top}")
    return result, dict(chains=out, elementwise_ms=ew / 1e3, kernel_ms=total / 1e3,
                        linked_ms=linked / 1e3)


def chain_bytes(cfg, tokens: int) -> dict:
    """The least bytes of each chain in one training step of ``cfg`` at
    ``tokens`` tokens, forward and backward, each input read once and each
    output written once in the model's dtype: the norms (x, y; x, dy, dx),
    the rotations (x, out both ways), the dense FFN's SwiGLU (gate and up
    read, h written; gate, up and dh read, their gradients written), the
    logits' float32 cast both ways, the embedding (rows gathered; the
    table's gradient written, the rows' read)."""
    es = 2 if cfg.dtype == "bfloat16" else 4
    T, D, L, V = tokens, cfg.d_model, cfg.n_layers, cfg.vocab
    norms = (2 * L + 1) * D + (L * cfg.mla.kv_lora_rank if cfg.mla else 0)
    if cfg.mla:
        rope = L * (cfg.n_heads + 1) * cfg.mla.qk_rope_head_dim
    else:
        rope = L * (cfg.n_heads + cfg.n_kv_heads) * cfg.resolved_head_dim
    out = {"norm": T * norms * 5 * es, "rope": T * rope * 4 * es,
           "logits: the float32 cast, the soft-cap": 2 * T * V * (es + 4),
           "embedding and its gradient": (V * D + 3 * T * D) * es}
    if cfg.moe is None:
        out["swiglu (dense FFN)"] = L * T * cfg.d_ff * 8 * es
    return out


def serve_on_card(cfg) -> tuple:
    """Serve ``cfg`` on the card: random weights drawn there from seed 0,
    then 8 requests of 20-500 prompt tokens and 16 new ones through a
    ``ServingEngine`` of 4 slots of 1024 positions, buckets 64-512, its
    steps sealed as CUDA graphs.  Fails unless every request finished with
    tokens in range and the graph replays equal the requests and the
    steps.  Returns the drained engine and the wrappers' counts over the
    served run: stream_pack launches, flash launches, flash layout copies,
    decode_attention launches and its layout copies, latent_attention
    launches and its layout copies."""
    import numpy as np
    import torch

    from repro_torch.kernels.decode_attention import kernel as decode
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.latent_attention import kernel as b6
    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    t0 = time.perf_counter()
    params = serve.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    say(f"weights: {n_params / 1e9:.3f} B parameters ({torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB on the card), initialised on the card in {time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()

    pack.launches = flash.launches = flash.layout_copies = 0   # the path's run starts here
    # B3's and B6's counts run on over every path (main reads them): a difference here
    b3_launches, b3_copies = decode.launches, decode.layout_copies
    b6_launches, b6_copies = b6.launches, b6.layout_copies
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, max_slots=SERVE_SLOTS, max_len=1024,
                           bucketing=f"pow2:{min(PREFILL_BUCKETS)}:{max(PREFILL_BUCKETS)}",
                           device="cuda")
    seal_s = time.perf_counter() - t0
    reqs = serve.make_requests(cfg, 8, max_new=16, seed=0, min_len=20, max_len=501)
    res = serve.serve(engine, reqs)
    torch.cuda.synchronize()
    counts = (pack.launches, flash.launches, flash.layout_copies,   # ... and ends here
              decode.launches - b3_launches, decode.layout_copies - b3_copies,
              b6.launches - b6_launches, b6.layout_copies - b6_copies)
    st = engine.stats
    captures = st.prefill_compiles + st.decode_compiles
    say(f"seal {seal_s:.2f}s ({st.prefill_compiles} prefill buckets + "
        f"{st.decode_compiles} decode captured) | prompt lengths "
        f"{sorted(len(r.prompt) for r in reqs)}")
    say(f"served {len(res['done'])} requests in {res['wall_s']:.3f}s | TTFT p50 "
        f"{res['ttft_p50_s'] * 1e3:.2f}ms | decode {res['decode_tok_per_s']:.1f} tok/s "
        f"over {st.steps} steps | peak max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say(f"CUDA graphs: {captures} captures, {st.prefill_replays} prefill + "
        f"{st.decode_replays} decode replays | wrapper calls (eager warm-up runs, plus "
        f"graph captures that record the kernel without running it): stream_pack "
        f"{counts[0]}, flash {counts[1]}, decode_attention {counts[3]}, latent_attention "
        f"{counts[5]}; layout copies {counts[2]} (flash), {counts[4]} (decode_attention), "
        f"{counts[6]} (latent_attention)")

    if len(res["done"]) != len(reqs):
        fail(f"{len(res['done'])} of {len(reqs)} requests finished")
    for r in res["done"]:
        if r.error or not (len(r.generated) == 16 or r.truncated):
            fail(f"request {r.rid}: {len(r.generated)} tokens, error {r.error}")
        toks = np.asarray(r.generated)
        if toks.min() < 0 or toks.max() >= cfg.vocab:
            fail(f"request {r.rid}: token outside [0, {cfg.vocab})")
    if st.prefill_replays != len(reqs) or st.decode_replays != st.steps:
        fail(f"graph replays: prefill {st.prefill_replays}, decode "
             f"{st.decode_replays} over {st.steps} steps")
    # the decode step's attention, each layer's, on B3 in the warm-up run and
    # the capture of every sealed decode step; MLA's absorbed attention on B6
    # in every sealed decode step and prompt pass instead
    want = 0 if cfg.mla else 2 * cfg.n_layers * st.decode_compiles
    if counts[3] != want or counts[4]:
        fail(f"decode_attention launched {counts[3]} times for {st.decode_compiles} captured "
             f"decode steps (want {want}), {counts[4]} layout copies")
    want = 2 * cfg.n_layers * captures if cfg.mla else 0
    if counts[5] != want or counts[6]:
        fail(f"latent_attention launched {counts[5]} times for {captures} captured steps "
             f"(want {want}), {counts[6]} layout copies")
    return engine, counts


def phase_serve() -> tuple[int, int | None, int]:
    """Returns the flash wrapper's calls over the served run, the flash
    kernels the profiler saw in one profiled prefill replay (None if it saw
    no device time there), and the B3 kernels it saw in one decode replay."""
    import repro_torch.configs as C

    say("== phase 4: serve phi4-mini-3.8b, full width and depth, bf16, on the card")
    cfg = dataclasses.replace(C.get("phi4-mini-3.8b"), dtype="bfloat16")
    engine, (_, launches, copies, *_) = serve_on_card(cfg)
    st = engine.stats
    if launches < cfg.n_layers * st.prefill_compiles or st.prefill_compiles < 1:
        fail(f"flash kernel launched {launches} times for {st.prefill_compiles} "
             f"captured prefill buckets: not on the main path")
    if copies != 0:
        fail(f"the served run made {copies} layout copies for the flash kernel: "
             "the model's layouts must be read in place")
    in_replays, b3_in_replay = step_breakdown(engine)
    return launches, in_replays, b3_in_replay


def _poison(out) -> None:
    """Fill the tensors ``out`` holds with values no run writes: NaN, or -1
    where they hold integers (token ids)."""
    import torch
    from torch.utils import _pytree as pytree

    for t in pytree.tree_leaves(out):
        if isinstance(t, torch.Tensor):
            t.fill_(float("nan") if t.is_floating_point() else -1)


def _same_outputs(got, want) -> bool:
    import torch
    from torch.utils import _pytree as pytree

    got = [t for t in pytree.tree_leaves(got) if isinstance(t, torch.Tensor)]
    want = [t for t in pytree.tree_leaves(want) if isinstance(t, torch.Tensor)]
    return len(got) == len(want) and all(
        g.shape == w.shape and bool(torch.isfinite(g.float()).all())
        and ratio(g, w, 1e-5, 1e-5) <= 1.0 for g, w in zip(got, want))


# GPU cycles (about 20 ms) that open each profiling session: on the card a
# session has come back without the kernels of its first milliseconds (the
# first 7 of 15 backward kernels, the first 108 of a prefill replay's 274),
# so a spin kernel takes that time and its own event is left out
PROFILE_SPIN_CYCLES = 40_000_000


def spin() -> None:
    """Open a profiling session: the spin kernel, then a synchronise, so
    that the work profiled starts after it."""
    import torch

    torch.cuda._sleep(PROFILE_SPIN_CYCLES)
    torch.cuda.synchronize()


def device_events(prof) -> list:
    """The device events of a profiler session but :func:`spin`'s."""
    return [e for e in prof.events() if "cuda" in str(getattr(e, "device_type", "")).lower()
            and "spin_kernel" not in e.name]


def second_call_kernels(run) -> list:
    """The device kernels of the second of two calls of ``run`` in one
    profiler session, each after a :func:`spin` kernel: the events that
    start after the last spin kernel ends.  A session has lost records of
    its first kernels even after the first spin (19c's training replay on
    an H100: 2963 of its 2973 kernels, the first norm's among those lost);
    the second call's are past that."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            spin()
            run()
            torch.cuda.synchronize()
    events = [e for e in prof.events() if "cuda" in str(getattr(e, "device_type", "")).lower()]
    spins = [e.time_range.end for e in events if "spin_kernel" in e.name]
    cut = max(spins) if len(spins) == 2 else float("inf")
    return [e for e in events if e.time_range.start >= cut and "spin_kernel" not in e.name]


def kernels_in_one(run, check: bool = True, attempts: int = 4) -> list:
    """The device kernels (torch.profiler events) of one call of ``run``,
    after one unprofiled call.

    With ``check`` (a call that computes the same outputs each time, as a
    graph replay does) the outputs of the call before are poisoned before
    each profiled call (a graph replay writes into those same tensors
    anew), and the profiled call must give the unprofiled call's outputs
    again: one that ran nothing fails the run.  Only then is a reading
    taken, and only when two sessions in a row record the same kernels:
    an H100 run has returned an empty activity buffer for a replay, and
    another a buffer of 25 of a replay's 300-odd kernels, and two sessions
    in a row have come back cut at the same place, so two that agree count
    only when no earlier session recorded more.  Up to ``attempts``
    sessions; else the reading with the most device events.  Without
    ``check`` (a call that moves state, as an eager decode step does) one
    session is taken."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils import _pytree as pytree

    events: list = []
    readings: list = []                  # (kernel counts, events) of each session
    with torch.no_grad():
        last = run()
        torch.cuda.synchronize()
        want = pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, last)
        for _ in range(attempts if check else 1):
            if check:
                _poison(last)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                spin()
                last = run()
                torch.cuda.synchronize()
            if check and not _same_outputs(last, want):
                fail("a profiled call did not give the outputs of the call before it: "
                     "it ran nothing, or not all of its work")
            events = device_events(prof)
            if not check:
                break
            if not events:
                say("    (the profiler recorded no device event for a call whose outputs "
                    "were right: profiling again)")
                continue
            counts = collections.Counter(e.name for e in events)
            if (readings and readings[-1][0] == counts
                    and all(len(ev) <= len(events) for _, ev in readings)):
                break
            if readings:
                say(f"    (two profiler sessions of one call recorded {len(readings[-1][1])} "
                    f"and {len(events)} device events: profiling again)")
            readings.append((counts, events))
        else:
            if check and readings:
                events = max((ev for _, ev in readings), key=len)
    return events


def by_kernel(events) -> list[tuple[float, int, str]]:
    """(device µs, count, name) of each kernel among ``events``."""
    by_name: dict[str, tuple[float, int]] = {}
    for e in events:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    return [(us, count, name) for name, (us, count) in by_name.items()]


def replay_times(engine):
    """Print the graph-replay times of the decode step and of each prefill
    bucket (CUDA events); returns the decode step's token input."""
    import torch

    params, cache = engine.params, engine.kv_cache
    toks = torch.zeros((engine.max_slots, 1), dtype=torch.long)
    parts = [f"decode step {time_ms(lambda: engine._decode(params, cache, toks), 20):.3f}"]
    for b in engine.prompt_buckets:
        exe, padded = engine._get_prefill_exec(b), torch.zeros((1, b), dtype=torch.long)
        parts.append(f"prefill {b} {time_ms(lambda: exe(params, cache, padded, 0, b), 5):.3f}")
    say(f"graph replay ms: {' | '.join(parts)}")
    return toks


def step_breakdown(engine) -> tuple[int | None, int]:
    """Where a served step's time goes: graph-replay times of the decode
    step and of each prefill bucket (CUDA events), the kernels of one
    decode graph replay (which must run B3 once a layer), then the device
    time of one eager decode step and one eager bucket-512 prefill by
    kernel (torch.profiler).  Returns the flash kernels the profiler saw
    run inside one prefill graph replay (None if it saw no device time
    there) and the B3 kernels of the decode replay.  Runs on the drained
    engine; only its idle cache is overwritten."""
    import torch

    params, cache = engine.params, engine.kv_cache
    toks = replay_times(engine)

    # replays do not pass through the wrapper's counter: count the flash
    # kernels that one replay runs on the card
    b = engine.prompt_buckets[-1]
    exe, padded = engine._get_prefill_exec(b), torch.zeros((1, b), dtype=torch.long)
    rows = by_kernel(kernels_in_one(lambda: exe(params, cache, padded, 0, b)))
    per_replay = None
    if rows:
        per_replay = sum(c for _, c, key in rows if "flash_fwd" in key)
        say(f"one prefill {b} graph replay ran {sum(c for _, c, _ in rows)} device ops, "
            f"{per_replay} of them flash_fwd (torch.profiler)")
        if per_replay != engine.cfg.n_layers:
            fail(f"a prefill replay ran {per_replay} flash kernels for "
                 f"{engine.cfg.n_layers} layers")
        check_norm_rope(rows, engine.cfg, f"prefill {b} replay",
                        again=lambda: exe(params, cache, padded, 0, b))
    else:
        say(f"one prefill {b} graph replay: the profiler saw no device time")
    b3 = decode_replay_b3(engine, toks)

    dev = engine.device
    eager = {
        "decode": lambda: engine._decode_impl(params, cache, toks.to(dev)),
        "prefill 512": lambda: engine._prefill_dyn(
            params, cache, torch.zeros((1, 512), dtype=torch.long, device=dev),
            torch.tensor(0, device=dev), torch.tensor(512, device=dev)),
    }
    for name, fn in eager.items():
        rows = by_kernel(kernels_in_one(fn, check=False))
        total = sum(r[0] for r in rows)
        if total <= 0:
            say(f"eager {name}: the profiler saw no device time")
            continue
        copies = sum(count for _, count, key in rows if "copy" in key.lower())
        say(f"eager {name}: {total / 1e3:.3f} ms of device time, {len(rows)} kernel names, "
            f"{sum(count for _, count, _ in rows)} kernels, {copies} of them copy kernels; "
            "top kernels:")
        for us, count, key in sorted(rows, reverse=True)[:8]:
            say(f"  {us / total:6.1%} {us / 1e3:8.3f} ms x{count:<4d} {key[:90]}")
    return per_replay, b3


# B3's kernel, and the names of the two kernels of its first design (a
# partial pass and a combine), which no replay may run
B3_KERNEL = "decode_attention_kernel"
B3_OLD_KERNELS = ("decode_partial", "decode_combine")


def b3_kernels(rows) -> tuple[int, int]:
    """B3's kernels among :func:`by_kernel` rows, and its first design's."""
    return (sum(c for _, c, key in rows if B3_KERNEL in key),
            sum(c for _, c, key in rows if any(k in key for k in B3_OLD_KERNELS)))


# the profiled decode replays check_b3_replay held, B3's kernels the
# profiler saw in them, and the B3 calls they replay (one per attention
# layer)
B3_REPLAYS = {"replays": 0, "kernels": 0, "calls": 0}


def check_b3_replay(rows, want: int, label: str) -> int:
    """Fails unless a profiled decode replay's kernels (``rows``) hold
    ``want`` B3 kernels, one per call, and none of the first design's;
    adds them to ``B3_REPLAYS``, returns the count and prints B3's share of
    the replay's kernel time."""
    n, old = b3_kernels(rows)
    B3_REPLAYS["replays"] += 1
    B3_REPLAYS["kernels"] += n
    B3_REPLAYS["calls"] += want
    total = sum(us for us, _, _ in rows)
    b3_us = sum(us for us, _, key in rows if B3_KERNEL in key)
    say(f"  {label}: {n} {B3_KERNEL} kernels, {b3_us / 1e3:.3f} ms ({b3_us / total:.1%} of "
        "the replay's kernel time)")
    if n != want or old:
        fail(f"{label}: a decode replay ran {n} B3 kernels and {old} of its first design's "
             f"partial passes and combines, want {want} and none (one per attention layer)")
    return n


# B6's kernels: the attention and, after a split over positions, the combine
B6_KERNELS = ("latent_attention_kernel", "latent_combine")
# the profiled replays check_b6_replay held, B6's kernels the profiler saw in
# them, and the B6 calls they replay (one per MLA layer)
B6_REPLAYS = {"replays": 0, "kernels": 0, "calls": 0}


def b6_kernels_per_call(cfg, B: int, S: int, T: int) -> int:
    """The kernels one B6 call runs for ``cfg``'s MLA at (B, S) queries
    over T positions in the model's dtype: its plan's."""
    from repro_torch.kernels.latent_attention import kernel as b6

    m = cfg.mla
    return b6.choose_launch(B, S, cfg.n_heads, T, m.kv_lora_rank, m.qk_rope_head_dim,
                            cfg.dtype).kernels


def check_b6_replay(rows, calls: int, per_call: int, label: str) -> int:
    """Fails unless a profiled replay's kernels (``rows``) hold ``calls``
    B6 calls of ``per_call`` kernels each; adds them to ``B6_REPLAYS``,
    returns the count and prints B6's share of the replay's kernel time."""
    n = sum(c for _, c, key in rows if any(k in key for k in B6_KERNELS))
    b6_us = sum(us for us, _, key in rows if any(k in key for k in B6_KERNELS))
    total = sum(us for us, _, _ in rows)
    B6_REPLAYS["replays"] += 1
    B6_REPLAYS["kernels"] += n
    B6_REPLAYS["calls"] += calls
    say(f"  {label}: {n} B6 kernels ({calls} calls of {per_call}), {b6_us / 1e3:.3f} ms "
        f"({b6_us / total:.1%} of the replay's kernel time)")
    if n != calls * per_call:
        fail(f"{label}: a replay ran {n} B6 kernels, want {calls * per_call} ({calls} MLA "
             f"layers x {per_call} a call)")
    return n


def decode_replay_b3(engine, toks) -> int:
    """The kernels of one decode graph replay of a served engine from the
    offsets of the call before it (torch.profiler), its top ops; B3 must run
    once per attention layer."""
    params, cache, cfg = engine.params, engine.kv_cache, engine.cfg
    pos0 = cache["pos"].clone()

    def decode_replay():
        cache["pos"].copy_(pos0)
        return engine._decode(params, cache, toks)

    rows = by_kernel(kernels_in_one(decode_replay))
    if not rows:
        fail("one decode graph replay: the profiler saw no device time")
    total = sum(us for us, _, _ in rows)
    say(f"one decode graph replay: {sum(c for _, c, _ in rows)} device ops, "
        f"{total / 1e3:.3f} ms of kernels (torch.profiler); top:")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        say(f"  {us / total:6.1%} {us / 1e3:8.3f} ms x{count:<4d} {key[:90]}")
    check_norm_rope(rows, cfg, "decode replay", again=decode_replay)
    return check_b3_replay(rows, 0 if cfg.mla else cfg.n_layers, "decode replay")


def phase_cpu_parity() -> None:
    import numpy as np
    import torch

    import repro_torch.configs as C
    from repro_torch.launch import serve
    from repro_torch.models import Transformer, prefill
    from repro_torch.serving import ServingEngine

    say("== phase 5: card against CPU, phi4-mini full width, 2 layers, float32 "
        "(logits within 1e-3: float32 summation order differs across devices)")
    cfg = dataclasses.replace(C.get("phi4-mini-3.8b"), n_layers=2, dtype="float32")
    p_gpu = serve.init_params(cfg, seed=1, device="cuda")
    p_cpu = Transformer(cfg, device="cpu")
    p_cpu.load_state_dict(p_gpu.state_dict())

    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (1, 64)).astype(np.int64))
    with torch.no_grad():
        lg = prefill(p_gpu, tokens.cuda(), cfg)[0][..., : cfg.vocab].cpu()
        lc = prefill(p_cpu, tokens, cfg)[0][..., : cfg.vocab]
    err = (lg - lc).abs().max().item()
    say(f"prefill logits (1, 64, {cfg.vocab}): max |cuda - cpu| {err:.3e}")
    if not err <= 1e-3:
        fail(f"prefill logits differ by {err} > 1e-3")

    out = {}
    for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
        engine = ServingEngine(cfg, params, max_slots=4, max_len=128,
                               bucketing=(64,), device=dev)
        reqs = serve.make_requests(cfg, 4, max_new=8, seed=2, min_len=8, max_len=65)
        out[dev] = {r.rid: r.generated for r in serve.serve(engine, reqs)["done"]}
    say(f"greedy tokens cuda: {out['cuda']}")
    say(f"greedy tokens cpu:  {out['cpu']}")
    if out["cuda"] != out["cpu"]:
        fail("greedy tokens differ between the card and the CPU")


# stream_pack (atol, rtol): float32 differs from its plain version only by
# summation order; bf16 also by the rounding of the output to bf16
PACK_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-2)}
# (lanes, M, K, N) of the packed mm groups of the four branchy cells
BRANCHY_PACKS = {"darts-like": (7, 8, 64, 64), "nasnet-m-like": (12, 8, 48, 48),
                 "amoebanet-like": (11, 8, 56, 56), "inception-like": (6, 8, 96, 96)}
# phase 6's (M, K, N): PR 12's ten, then K or N off the 16-byte vector
# (element-wise loads), and K deep enough that the f32 panel does not fit
# (the ring at 8, 16 and 32 rows)
PACK_SHAPES = [(16, 16, 16), (64, 32, 16), (128, 128, 128), (256, 64, 128), (8, 64, 64),
               (8, 48, 48), (8, 56, 56), (8, 96, 96), (32, 256, 256), (200, 72, 40),
               (8, 13, 7), (33, 40, 29), (8, 1024, 64), (8, 1022, 40), (16, 1024, 64),
               (64, 1024, 64)]
# ... and with x 4 bytes past a 16-byte boundary, which takes the element-wise
# loads of every tile
PACK_OFFSET_SHAPES = [(8, 64, 64), (33, 40, 29), (16, 16, 16), (32, 256, 256),
                      (16, 1024, 64), (64, 1024, 64)]
# ... and with x or w (or both) transposed, read where they lie by the
# element-wise loads of every ring: the layouts of B2's backward (dx = dy wᵀ,
# dw = xᵀ dy) at the branchy cells', the smoke experts' and odd shapes
PACK_LAYOUT_SHAPES = [(8, 64, 64), (33, 40, 29), (16, 16, 16), (32, 256, 256),
                      (8, 1024, 64), (64, 1024, 64), (80, 64, 32)]
# the bf16 weight stream's instances (lanes, M, K, N, layout): row tiles 16,
# 32 and 64 (M 4, 24, 40, 64: rows past M zero-filled, not stored), x and w
# row-major (nn) or w transposed (nt), x transposed (tn: 64-row tiles, M 520
# ending inside one, K 72 a partial chunk); N 1000 and 584 end inside a
# 256-column tile (584 inside its second 64-column box: the others are not
# loaded); fewer items than SMs, or more
PACK_TMA_SHAPES = [(lanes, M, K, N, layout) for layout in ("nn", "nt")
                   for lanes, K, N, rows in ((2, 1024, 1000, (4, 24, 64)),
                                             (33, 1024, 584, (16, 40)))
                   for M in rows] + [(1, 520, 72, 1032, "tn"), (3, 520, 72, 1032, "tn")]
# the wgmma kernel's ragged edges (lanes, M, K, N, layout): a training
# capacity of 65, 200 or 383 tokens as the forward's and dx's M (rows past M
# zero-filled, a second warpgroup with 1 row or none, never stored) and as
# dw's depth (the tokens: a last chunk 9, 8 or 63 deep); K 1000 and 520 end
# inside a chunk; N 1000, 584 and 1032 inside a 256-column tile (584 and
# 1032 inside its second or first 64-column box: the boxes past N are not
# loaded); dw's rows 1032 end 8 rows into a tile (its second x box not
# loaded), 1000 inside its second box
PACK_WGMMA_SHAPES = [(lanes, M, K, N, layout) for layout in ("nn", "nt")
                     for lanes, M, K, N in ((3, 65, 1024, 1000), (2, 200, 1000, 584),
                                            (2, 383, 520, 1032))] + [
    (3, 1000, 200, 1000, "tn"), (2, 1032, 383, 584, "tn"), (1, 1024, 136, 264, "tn")]


def pack_cases() -> list[tuple[str, int, tuple[int, int, int], bool, int, str]]:
    """Phase 6's (dtype, lanes, (M, K, N), shared x, x's byte offset, layout)
    cases; the layout is x's and w's, n row-major, t transposed."""
    dtypes = ("float32", "bfloat16")
    cases = [(dname, lanes, mkn, shared, 0, "nn") for dname in dtypes
             for lanes in (1, 2, 7, 12) for mkn in PACK_SHAPES for shared in (False, True)]
    cases += [(dname, lanes, mkn, shared, 4, "nn") for dname in dtypes
              for lanes in (1, 7) for mkn in PACK_OFFSET_SHAPES for shared in (False, True)]
    cases += [(dname, lanes, mkn, shared, 0, layout) for dname in dtypes
              for lanes in (1, 7) for mkn in PACK_LAYOUT_SHAPES for shared in (False, True)
              for layout in ("tn", "nt", "tt")]
    return cases + [("bfloat16", lanes, (M, K, N), shared, 0, layout)
                    for lanes, M, K, N, layout in PACK_TMA_SHAPES + PACK_WGMMA_SHAPES
                    for shared in (False, True)]


def _pack_inputs(lanes, M, K, N, dtype, shared, seed, offset=0, layout="nn"):
    """x (lanes, M, K), a stride-0 broadcast of one (M, K) when shared, and
    w (lanes, K, N), standard normal on the card; ``layout`` "t" for x
    (w) makes it the transpose of a contiguous (lanes, K, M) ((lanes, N,
    K)).  ``offset`` > 0 puts x's first element that many bytes past a
    16-byte boundary."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = (1 if shared else lanes) * M * K
    skip = offset // torch.empty((), dtype=dtype).element_size()
    x = torch.randn(skip + rows, generator=g, device="cuda").to(dtype)[skip:]
    x = x.view(K, M).t() if layout[0] == "t" and shared else \
        x.view(lanes, K, M).transpose(1, 2) if layout[0] == "t" else \
        x.view(M, K) if shared else x.view(lanes, M, K)
    if shared:
        x = x.expand(lanes, M, K)
    w = torch.randn((lanes, K, N), generator=g, device="cuda").to(dtype)
    if layout[1] == "t":
        w = w.transpose(1, 2).contiguous().transpose(1, 2)
    return x, w


def _tile(launch) -> str:
    cluster = f" in clusters of {launch.cluster}" if launch.cluster > 1 else ""
    return (f"{launch.variant} tile {launch.bm}x{launch.bn} kc {launch.kc} stages "
            f"{launch.stages} grid {launch.grid}{cluster} smem {launch.smem_bytes} B")


def pack_coverage(launches) -> set:
    """What phase 6 must reach: every kernel of ``INSTANCES``, and every
    layout of x and w through each ring's element-wise loads (the stream's
    layouts are its instances); ``launches`` the launches made, returns
    what they miss."""
    from repro_torch.kernels.stream_pack import kernel as pack

    want = set(pack.INSTANCES) | {(v, layout) for v, _, _ in pack.INSTANCES
                                  if v.endswith("/elem") for layout in pack.LAYOUTS}
    got = {ln.instance for ln in launches} | {(ln.variant, ln.layout) for ln in launches}
    return want - got


def pack_registers(log: str | None = None) -> dict:
    """:func:`ptxas_report` of B2's wgmma kernels (``log``, or the build log
    of ``stream_pack.cu``), by name: ``stream_pack_wgmma<nn>``, ``<nt>``,
    ``<tn>`` (template arguments x transposed, w transposed)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.stream_pack import kernel as pack

    def name_in(line):
        found = re.search(r"stream_pack_wgmmaILb([01])ELb([01])E", line)
        return found and "stream_pack_wgmma<" + "nt"[int(found[1])] + "nt"[int(found[2])] + ">"

    return ptxas_report([build.build_log(pack.SOURCE) if log is None else log], name_in)


def check_pack_registers() -> dict:
    """Print the wgmma kernels' registers and spills; fail on a spill, on
    a serialization note or on a kernel missing from the report."""
    regs = pack_registers()
    say("  ptxas, B2's wgmma kernels: " + "; ".join(
        f"{k} {v.get('registers')} registers, spills {v.get('spills')}, wgmma serialized "
        f"{v['serialized']}" for k, v in sorted(regs.items())))
    want = {f"stream_pack_wgmma<{lay}>" for lay in ("nn", "nt", "tn")}
    bad = sorted(k for k, v in regs.items() if v["serialized"] or v.get("spills", (0, 0)) != (0, 0))
    if set(regs) != want or bad:
        fail(f"ptxas: B2's wgmma kernels {sorted(regs)} (want {sorted(want)}) spill or serialize "
             f"their wgmma: {bad}")
    return regs


def phase_stream_pack() -> dict:
    import torch

    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.kernels.stream_pack import stream_pack_matmul, stream_pack_matmul_ref

    say("== phase 6: stream_pack kernel vs plain version (tolerance |err| <= atol + "
        "rtol*|ref|: f32 1e-4 + 1e-5*|ref| for summation order; bf16 1e-2 + "
        "1e-2*|ref| for the rounding of the output)")
    registers = check_pack_registers()
    cases = pack_cases()
    worst, reached, made = 0.0, {}, []
    for n, (dname, lanes, (M, K, N), shared, offset, layout) in enumerate(cases):
        x, w = _pack_inputs(lanes, M, K, N, getattr(torch, dname), shared, seed=n,
                            offset=offset, layout=layout)
        launch = pack.launch_for(x, w)
        if launch.layout != layout:
            fail(f"phase 6 made x and w of layout {layout}, launch_for read {launch.layout}")
        # one block per dimension passes the TPU's block check for any
        # shape; the CUDA tile still meets the ragged edge
        got = stream_pack_matmul(x, w, block_m=M, block_n=N, block_k=K)
        ref = stream_pack_matmul_ref(x, w)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        r = ratio(got, ref, *PACK_TOL[dname])
        if not (math.isfinite(err) and r <= 1.0):
            fail(f"stream_pack disagrees at {dname} lanes={lanes} M={M} K={K} N={N} "
                 f"shared={shared} x offset {offset} B layout {layout} ({_tile(launch)}): "
                 f"max_abs_err {err} ({r:.3f} of tolerance {PACK_TOL[dname]})")
        worst = max(worst, r)
        reached[launch.instance] = reached.get(launch.instance, 0) + 1
        made.append(launch)
    say(f"  float32 and bfloat16: lanes 1/2/7/12 x {len(PACK_SHAPES)} shapes x "
        f"shared/separate; lanes 1/7 x {len(PACK_OFFSET_SHAPES)} shapes x "
        f"shared/separate with x 4 bytes off 16; lanes 1/7 x {len(PACK_LAYOUT_SHAPES)} shapes "
        f"x shared/separate x layouts tn/nt/tt; bf16 {len(PACK_TMA_SHAPES)} stream shapes and "
        f"{len(PACK_WGMMA_SHAPES)} ragged wgmma shapes x shared/separate: all within tolerance")
    say(f"  {len(cases)} cases within tolerance (worst at {worst:.2f} of its tolerance); "
        f"cases by kernel (variant, bm, bn): "
        + ", ".join(f"{v} {bm}x{bn} {n}" for (v, bm, bn), n in sorted(reached.items())))
    missing = pack_coverage(made)
    if missing:
        fail(f"phase 6 never launched the stream_pack kernels or layouts {sorted(missing)}")

    say("-- timing: the branchy cells' packed mm groups (f32, shared x) and one bf16 shape")
    record = {}
    cases = [(name, *lmkn, "float32", True) for name, lmkn in BRANCHY_PACKS.items()]
    cases.append(("bf16 12x32x256x256", 12, 32, 256, 256, "bfloat16", False))
    for name, lanes, M, K, N, dname, shared in cases:
        x, w = _pack_inputs(lanes, M, K, N, getattr(torch, dname), shared, seed=1000 + lanes)
        launch = pack.launch_for(x, w)
        got, ref = stream_pack_matmul(x, w), stream_pack_matmul_ref(x, w)
        err = (got.float() - ref.float()).abs().max().item()
        if not ratio(got, ref, *PACK_TOL[dname]) <= 1.0:
            fail(f"stream_pack disagrees at {name}: max_abs_err {err}")
        calls = {"kernel": lambda: stream_pack_matmul(x, w),
                 "plain": lambda: stream_pack_matmul_ref(x, w),
                 "library": lambda: torch.matmul(x, w)}
        # launched one by one from Python, and inside a CUDA graph
        eager = {k: time_ms(f, 200) for k, f in calls.items()}
        graphed = {k: graph_ms(f) for k, f in calls.items()}
        kernel_ms, plain_ms, library_ms = graphed["kernel"], graphed["plain"], graphed["library"]
        itemsize = x.element_size()
        # each input read once (a shared x once, not once per lane), the
        # output written once
        nbytes = ((1 if shared else lanes) * M * K + lanes * K * N + lanes * M * N) * itemsize
        flops = 2.0 * lanes * M * N * K
        bound_ms, bound_by = bound(flops, nbytes, dname)
        say(f"  {name} (lanes {lanes}, M {M}, K {K}, N {N}, {dname}, shared x {shared}; "
            f"{_tile(launch)}): in a CUDA graph kernel_ms {kernel_ms:.5f} plain_ms "
            f"{plain_ms:.5f} library_ms {library_ms:.5f} | launched from Python kernel_ms {eager['kernel']:.5f} "
            f"plain_ms {eager['plain']:.5f} library_ms {eager['library']:.5f} | "
            f"bound_ms {bound_ms:.6f} ({bound_by}) max_abs_err {err:.3e} | "
            f"{flops / 1e6:.3f} MFLOP, {nbytes / 1e3:.1f} KB")
        if name == "darts-like":     # the first cell of the main path's run
            record = dict(max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    record["expert_shapes"] = expert_gemms()
    record["train_shapes"] = train_gemms()
    record["ptxas_wgmma"] = registers
    record["instances"] = [f"{v} {bm}x{bn}" for v, bm, bn in pack.INSTANCES]
    return record


# phase 6's MoE expert GEMMs on B2: (lanes, d_model, d_ff_expert) of each
# served MoE model; w_gate and w_up are (lanes, d_model, d_ff_expert), w_down
# (lanes, d_ff_expert, d_model), and M is the capacity serving gives them
EXPERT_GEMMS = {"arctic-480b": (128, 7168, 4864), "deepseek-v2-236b": (160, 5120, 1536)}
# the M that are timed: 4 decode slots, and prefill bucket 64 (dropless)
EXPERT_TIMED_M = (4, 64)
# the case run twice, whose two outputs must have the same bits
EXPERT_REPEAT = ("deepseek-v2-236b", "gate/up", 64)
# lanes per call of the plain version on the card, which upcasts w to float32
# (17.8 GB for all of arctic's lanes)
REF_LANES = 16


def expert_capacities(arch: str) -> tuple[int, ...]:
    """Every M the served path gives ``arch``'s expert GEMMs: the capacity
    of a decode step over ``SERVE_SLOTS`` slots and of a prefill at each of
    ``PREFILL_BUCKETS``."""
    import repro_torch.configs as C
    from repro_torch.models.moe import capacity

    cfg = C.get(arch)
    return tuple(sorted({capacity(n, cfg) for n in (SERVE_SLOTS,) + PREFILL_BUCKETS}))


def expert_gemms() -> list[dict]:
    """B2 at the MoE expert GEMMs, bf16, random normal operands, at every M
    of :func:`expert_capacities`: against the plain version, computed
    REF_LANES lanes at a time, under ``PACK_TOL``; then, at the M of
    ``EXPERT_TIMED_M``, times in a CUDA graph and launched from Python beside one
    ``torch.bmm`` over the same operands (a yardstick only: the port never
    calls it), the plain version (launched from Python) and the bound,
    which is the weights' bytes.  ``EXPERT_REPEAT`` runs twice and must give
    the same bits."""
    import torch

    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.kernels.stream_pack import stream_pack, stream_pack_matmul_ref

    say("-- the MoE expert GEMMs at full width, bf16 (x (lanes,M,K) @ w (lanes,K,N)), at every "
        f"capacity the served path gives them, timed at M {EXPERT_TIMED_M}; ms per call")
    entries = []
    for arch, (lanes, D, F) in EXPERT_GEMMS.items():
        for gemm, K, N in (("gate/up", D, F), ("down", F, D)):
            g = torch.Generator(device="cuda").manual_seed(lanes + K)
            w = torch.randn((lanes, K, N), generator=g, device="cuda", dtype=torch.bfloat16)
            for M in expert_capacities(arch):
                x = torch.randn((lanes, M, K), generator=g, device="cuda", dtype=torch.bfloat16)
                launch = pack.launch_for(x, w)
                got = stream_pack(x, w)
                worst = err = 0.0
                for i in range(0, lanes, REF_LANES):
                    ref = stream_pack_matmul_ref(x[i:i + REF_LANES], w[i:i + REF_LANES])
                    part = got[i:i + REF_LANES]
                    worst = max(worst, ratio(part, ref, *PACK_TOL["bfloat16"]))
                    err = max(err, (part.float() - ref.float()).abs().max().item())
                    del ref
                if not (math.isfinite(err) and worst <= 1.0):
                    fail(f"stream_pack disagrees at {arch} {gemm} M={M}: max_abs_err {err} "
                         f"({worst:.3f} of tolerance {PACK_TOL['bfloat16']})")
                if (arch, gemm, M) == EXPERT_REPEAT:
                    again = stream_pack(x, w)
                    if not torch.equal(again.view(torch.int16), got.view(torch.int16)):
                        fail(f"two runs of stream_pack at {arch} {gemm} M={M} differ in "
                             f"{(again != got).sum().item()} elements")
                    say(f"  {arch} {gemm} M {M}: two runs bit-identical")
                    del again
                if M not in EXPERT_TIMED_M:
                    say(f"  {arch} {gemm} lanes {lanes} M {M} K {K} N {N} ({_tile(launch)}): "
                        f"{worst:.2f} of tolerance, max_abs_err {err:.3e}")
                    continue
                calls = {"kernel": lambda: stream_pack(x, w), "library": lambda: torch.bmm(x, w)}
                graphed = {k: graph_ms(f, reps=5, iters=10) for k, f in calls.items()}
                eager = {k: time_ms(f, 20) for k, f in calls.items()}
                plain_ms = time_ms(lambda: stream_pack_matmul_ref(x, w), 3, warmup=1)
                nbytes = (lanes * M * K + lanes * K * N + lanes * M * N) * 2
                flops = 2.0 * lanes * M * N * K
                bound_ms, bound_by = bound(flops, nbytes, "bfloat16")
                say(f"  {arch} {gemm} lanes {lanes} M {M} K {K} N {N} ({_tile(launch)}): "
                    f"{worst:.2f} of tolerance, max_abs_err {err:.3e} | in a CUDA graph "
                    f"kernel_ms {graphed['kernel']:.5f} library_ms (torch.bmm) "
                    f"{graphed['library']:.5f} | from Python kernel_ms {eager['kernel']:.5f} "
                    f"library_ms {eager['library']:.5f} plain_ms {plain_ms:.5f} | bound_ms "
                    f"{bound_ms:.5f} ({bound_by}, {nbytes / 1e9:.3f} GB) | kernel at "
                    f"{bound_ms / graphed['kernel']:.1%} of bound, "
                    f"{graphed['library'] / graphed['kernel']:.3f}x the library's speed")
                entries.append(dict(model=arch, gemm=gemm, lanes=lanes, M=M, K=K, N=N,
                                    variant=launch.variant, bm=launch.bm, bn=launch.bn,
                                    stages=launch.stages, grid=launch.grid[0], max_abs_err=err,
                                    ms=graphed["kernel"], eager_ms=eager["kernel"],
                                    plain_ms=plain_ms, library_ms=graphed["library"],
                                    eager_library_ms=eager["library"], bound_ms=bound_ms,
                                    bound_by=bound_by))
            del w, x, got
            torch.cuda.empty_cache()
    return entries


# DeepSeek-V2's training capacity: capacity(2 x 4096 tokens) of 19h's step
TRAIN_EXPERT_M = 384
# the (product, gemm) run twice at that capacity, whose outputs must have the
# same bits
TRAIN_REPEAT = ("dw", "gate/up")


def train_products(lanes: int, M: int, K: int, N: int, seed: int):
    """The three products of one expert GEMM at capacity M, bf16, random
    normal operands on the card: {product: (layout, a, b)} with the
    forward x (lanes, M, K) @ w (lanes, K, N) (nn), dx = dy @ wᵀ (nt) and
    dw = xᵀ @ dy (tn), wᵀ and xᵀ as the views the backward passes."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((lanes, K, N), generator=g, device="cuda", dtype=torch.bfloat16)
    x = torch.randn((lanes, M, K), generator=g, device="cuda", dtype=torch.bfloat16)
    dy = torch.randn((lanes, M, N), generator=g, device="cuda", dtype=torch.bfloat16)
    return {"forward": ("nn", x, w), "dx": ("nt", dy, w.transpose(1, 2)),
            "dw": ("tn", x.transpose(1, 2), dy)}


def train_gemms() -> list[dict]:
    """B2 at deepseek-v2-236b's expert GEMMs at its training capacity
    (``TRAIN_EXPERT_M``), bf16, 160 lanes: the forward, dx and dw of gate/up
    and of down, each against the plain version ``REF_LANES`` lanes at a
    time under ``PACK_TOL``, ``TRAIN_REPEAT`` twice for the same bits, then
    timed in a CUDA graph and launched from Python beside one ``torch.bmm``
    over the same views (a yardstick only: the port never calls it) and
    the bound, which is the bytes (3.3 GB) by a hair over the operations."""
    import torch

    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.kernels.stream_pack import stream_pack, stream_pack_matmul_ref

    lanes, D, F = EXPERT_GEMMS["deepseek-v2-236b"]
    M = TRAIN_EXPERT_M
    say(f"-- deepseek-v2-236b's expert GEMMs at its training capacity M {M}, bf16, {lanes} "
        "lanes: forward x w (nn), dx = dy w^T (nt), dw = x^T dy (tn); ms per call")
    entries = []
    for gemm, K, N in (("gate/up", D, F), ("down", F, D)):
        products = train_products(lanes, M, K, N, seed=lanes + K + M)
        for product, (layout, a, b) in products.items():
            launch = pack.launch_for(a, b)
            if launch.layout != layout or not launch.variant.startswith("bf16_wgmma"):
                fail(f"{gemm} {product} at M {M} took {_tile(launch)}, not bf16_wgmma/{layout}")
            got = stream_pack(a, b)
            worst = err = 0.0
            for i in range(0, lanes, REF_LANES):
                ref = stream_pack_matmul_ref(a[i:i + REF_LANES], b[i:i + REF_LANES])
                part = got[i:i + REF_LANES]
                worst = max(worst, ratio(part, ref, *PACK_TOL["bfloat16"]))
                err = max(err, (part.float() - ref.float()).abs().max().item())
                del ref
            if not (math.isfinite(err) and worst <= 1.0):
                fail(f"stream_pack disagrees at deepseek-v2 {gemm} {product} M={M}: max_abs_err "
                     f"{err} ({worst:.3f} of tolerance {PACK_TOL['bfloat16']})")
            if (product, gemm) == TRAIN_REPEAT:
                again = stream_pack(a, b)
                if not torch.equal(again.view(torch.int16), got.view(torch.int16)):
                    fail(f"two runs of stream_pack at deepseek-v2 {gemm} {product} M={M} differ "
                         f"in {(again != got).sum().item()} elements")
                say(f"  {gemm} {product} M {M}: two runs bit-identical")
                del again
            del got
            (_, R, Dp), C = a.shape, b.shape[2]
            calls = {"kernel": lambda: stream_pack(a, b), "library": lambda: torch.bmm(a, b)}
            graphed = {k: graph_ms(f, reps=5, iters=10) for k, f in calls.items()}
            eager = {k: time_ms(f, 20) for k, f in calls.items()}
            plain_ms = time_ms(lambda: stream_pack_matmul_ref(a, b), 3, warmup=1)
            nbytes = 2 * lanes * (R * Dp + Dp * C + R * C)
            bound_ms, bound_by = bound(2.0 * lanes * R * C * Dp, nbytes, "bfloat16")
            say(f"  {gemm} {product} ({layout}: lanes {lanes}, M {R}, K {Dp}, N {C}; "
                f"{_tile(launch)}, {pack.resident_clusters(launch, a.device)} clusters "
                f"resident): {worst:.2f} of tolerance, max_abs_err {err:.3e} | in a CUDA "
                f"graph kernel_ms {graphed['kernel']:.5f} library_ms (torch.bmm) "
                f"{graphed['library']:.5f} | from Python kernel_ms {eager['kernel']:.5f} "
                f"library_ms {eager['library']:.5f} plain_ms {plain_ms:.5f} | bound_ms "
                f"{bound_ms:.5f} ({bound_by}, {nbytes / 1e9:.3f} GB) | kernel at "
                f"{bound_ms / graphed['kernel']:.1%} of "
                f"bound, {graphed['library'] / graphed['kernel']:.3f}x the library's speed")
            resident = pack.resident_clusters(launch, a.device)
            entries.append(dict(gemm=gemm, product=product, layout=layout, lanes=lanes, M=R,
                                K=Dp, N=C, variant=launch.variant, stages=launch.stages,
                                cluster=launch.cluster, resident_clusters=resident,
                                blocks=min(launch.grid[0] // launch.cluster, resident)
                                * launch.cluster, max_abs_err=err, ms=graphed["kernel"],
                                eager_ms=eager["kernel"], plain_ms=plain_ms,
                                library_ms=graphed["library"],
                                eager_library_ms=eager["library"], bound_ms=bound_ms,
                                bound_by=bound_by))
        del products, a, b
        torch.cuda.empty_cache()
    return entries


def span(events) -> str:
    """Summed kernel time and the device span of one call (µs)."""
    if not events:
        return "no device time seen"
    busy = sum(e.time_range.elapsed_us() for e in events)
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    return f"kernels {busy:.2f} us over a span of {t1 - t0:.2f} us"


def phase_nimble() -> tuple[int, int, int]:
    """Returns the stream_pack wrapper's calls over the run, the
    stream_pack kernels the profiler saw in the profiled packed replays, and
    the number of those replays (one per cell)."""
    import torch

    from repro_torch.configs import branchy_cell
    from repro_torch.core import EagerInterpreter, JitPerOpEngine, Nimble
    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.models.branchy import branchy_forward, example_input, init_branchy

    say("== phase 7: Nimble on the four branchy cells, full size, float32, on the card "
        "(replays within 1e-5 + 1e-5*|ref| of eager: the same aten kernels, cuBLAS may "
        "pick another algorithm under capture; packed within 1e-4 + 1e-4*|ref|)")
    configs = [branchy_cell.darts_like(), branchy_cell.nasnet_mobile_like(),
               branchy_cell.amoebanet_like(), branchy_cell.inception_like()]
    data = []
    for cfg in configs:
        params, other = (init_branchy(torch.Generator(device="cuda").manual_seed(seed), cfg,
                                      device="cuda") for seed in (0, 1))
        data.append((cfg, params, other, example_input(cfg, 0, device="cuda")))
    torch.cuda.synchronize()

    pack.launches = 0                     # the main path's run starts here
    in_replays = 0                        # stream_pack kernels seen in profiled replays
    mm_groups_total = 0
    for cfg, params, other, x in data:
        def fn(p, x, _cfg=cfg):
            return branchy_forward(p, x, _cfg)

        with torch.no_grad():
            ref = fn(params, x).clone()
        engines, nimbles = {}, {}
        engines["eager"] = lambda: fn(params, x)
        engines["interpreter"] = lambda e=EagerInterpreter(fn, params, x): e(params, x)
        engines["jit_per_op"] = lambda e=JitPerOpEngine(fn, params, x): e(params, x)
        for name, kw in (("single_stream", dict(multi_stream=False)), ("multi_stream", {}),
                         ("packed", dict(pack_streams=True))):
            nimbles[name] = Nimble(fn, params, x, **kw)
            engines[name] = lambda n=nimbles[name]: n(params, x)
        st = nimbles["multi_stream"].stats
        report = nimbles["packed"].schedule.pack_report
        mm_groups = sum(1 for op, _ in report.groups if op == "mm")
        mm_groups_total += mm_groups
        say(f"  {cfg.name}: {st.num_tasks} tasks, {st.num_streams} streams, {st.num_syncs} "
            f"syncs, degree {st.degree_of_concurrency}, pack groups {report.groups} "
            f"({report.baked_groups} baked)")
        pool = {name: n.stats.device_bytes for name, n in nimbles.items()}
        say(f"    planned arena_bytes {st.arena_bytes} | graph pool bytes (ScheduleStats."
            f"device_bytes, the change of memory_allocated across schedule): single "
            f"{pool['single_stream']}, multi {pool['multi_stream']}, packed {pool['packed']} "
            f"(packed includes its pre-stacked weights)")

        # correctness: each engine against eager, then each replay on
        # another input and on other weights, which it copies into its
        # static inputs (shared by the three schedules; the packed one
        # re-stacks the weights it baked): restored after each from copies
        tols = {"interpreter": (1e-5, 1e-5), "jit_per_op": (1e-5, 1e-5),
                "single_stream": (1e-5, 1e-5),
                "multi_stream": (1e-5, 1e-5), "packed": (1e-4, 1e-4)}
        x0, x2 = x.clone(), example_input(cfg, 1, device="cuda")
        p0 = {k: v.clone() for k, v in params.items()}
        with torch.no_grad():
            ref2, ref3 = fn(params, x2).clone(), fn(other, x2).clone()
        for name, (atol, rtol) in tols.items():
            got = engines[name]().clone()
            torch.cuda.synchronize()
            if got.shape != ref.shape or not torch.isfinite(got).all():
                fail(f"{cfg.name} {name}: shape {tuple(got.shape)} or non-finite output")
            r = ratio(got, ref, atol, rtol)
            if not r <= 1.0:
                fail(f"{cfg.name} {name} differs from eager: {r:.3f} of tolerance")
            if name in nimbles:
                got2 = nimbles[name](params, x2).clone()
                got3 = nimbles[name](other, x2).clone()
                back = nimbles[name](p0, x0).clone()
                for what, g, want in (("another input", got2, ref2),
                                      ("other weights", got3, ref3),
                                      ("the first weights again", back, ref)):
                    r2 = ratio(g, want, atol, rtol)
                    if not r2 <= 1.0:
                        fail(f"{cfg.name} {name} on {what}: {r2:.3f} of tolerance")
        if not (torch.equal(x, x0) and all(torch.equal(params[k], p0[k]) for k in p0)):
            fail(f"{cfg.name}: the static inputs were not restored")
        # B2 sums each output in a fixed order: two replays give the same bits
        first, second = engines["packed"]().clone(), engines["packed"]().clone()
        if not torch.equal(first, second):
            fail(f"{cfg.name}: two packed replays differ by "
                 f"{(first - second).abs().max().item()}")
        torch.cuda.synchronize()

        iters = 200
        us = {name: time_ms(run, iters, warmup=5) * 1e3 for name, run in engines.items()}
        say("    us per call (CUDA events, mean of 200 after 5 warm-up): " + " | ".join(
            f"{name} {v:.2f}" for name, v in us.items())
            + f" | multi/single {us['single_stream'] / us['multi_stream']:.3f}x")

        for name in ("single_stream", "multi_stream"):
            events = kernels_in_one(engines[name])
            ids = sorted({getattr(e, "device_resource_id", None) for e in events} - {None})
            say(f"    one {name} replay: {len(events)} device ops on "
                f"{len(ids) if ids else 'not measured'} stream ids {ids[:48]}; {span(events)}")
            if name == "single_stream":
                top = sorted(by_kernel(events), reverse=True)[:3]
                say("      top kernels: " + " | ".join(
                    f"{us:.2f} us x{count} {key[:70]}" for us, count, key in top))
        events = kernels_in_one(engines["packed"])
        b2_events = [e for e in events if "stream_pack_" in e.name]
        b2 = len(b2_events)
        b2_us = sum(e.time_range.elapsed_us() for e in b2_events)
        say(f"    one packed replay: {len(events)} device ops, {b2} stream_pack kernels "
            f"for {mm_groups} mm pack groups (torch.profiler); {span(events)}; "
            f"stream_pack kernels {b2_us:.2f} us ("
            + ", ".join(f"{e.time_range.elapsed_us():.2f}" for e in b2_events)
            + "); two replays bit-identical")
        if b2 != mm_groups:
            fail(f"{cfg.name}: the profiler saw {b2} stream_pack kernels in a packed "
                 f"replay for {mm_groups} mm groups")
        in_replays += b2
    torch.cuda.synchronize()
    launches = pack.launches             # ... and ends here
    say(f"stream_pack wrapper calls {launches} (one warm-up run and one graph capture, "
        f"which records the kernel without running it, per mm group); the profiler saw "
        f"{in_replays} stream_pack kernels in the {len(data)} profiled packed replays, "
        f"one per cell")
    if launches != 2 * mm_groups_total:
        fail(f"stream_pack launched {launches} times for {mm_groups_total} packed mm "
             f"groups: not on Nimble's packed path")
    return launches, in_replays, len(data)


def release() -> None:
    """Give back the memory of the phases before: their engines hold
    reference cycles (sealed steps that call back into the engine), so
    collect them, then return the cached blocks to the card."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    say(f"memory: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")


def phase_serve_moe(arch: str, number: int, n_layers: int = 2) -> dict:
    """Serve ``arch`` at full width and ``n_layers`` layers, bf16, as phase 4
    serves phi4-mini.  Returns the wrappers' counts over the served run
    and the kernels the profiler saw in one decode and one prefill replay."""
    import repro_torch.configs as C

    say(f"== phase {number}: serve {arch}, full width, {n_layers} layers, bf16, on the card")
    release()
    cfg = dataclasses.replace(C.get(arch), n_layers=n_layers, dtype="bfloat16")
    say(f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} of width {cfg.moe.d_ff_expert}"
        + (f" beside a dense FFN of {cfg.d_ff}" if cfg.d_ff else "")
        + (f", {cfg.moe.num_shared_experts} shared" if cfg.moe.num_shared_experts else "")
        + f", d_model {cfg.d_model}, "
        + ("MLA" if cfg.mla else f"GQA {cfg.n_heads} over {cfg.n_kv_heads} heads"))
    engine, (b2, fl, copies, _, _, b6, _) = serve_on_card(cfg)
    st = engine.stats
    captures = st.prefill_compiles + st.decode_compiles
    # three expert GEMMs per layer in every sealed step, each launched once
    # by the warm-up run and once by the capture; prefill attention on B1
    # for GQA, on B6 for MLA (serve_on_card counts B6 in every step)
    want_flash = 0 if cfg.mla else 2 * n_layers * st.prefill_compiles
    if b2 != 2 * 3 * n_layers * captures or fl != want_flash or copies:
        fail(f"stream_pack wrapper calls {b2} (want {2 * 3 * n_layers * captures}), flash "
             f"{fl} (want {want_flash}), layout copies {copies}: not the main path")
    seen = moe_replays(engine)
    return dict(b2_launches=b2, flash_launches=fl, b6_launches=b6, **seen)


def moe_replays(engine) -> dict:
    """:func:`replay_times`, then the device kernels of one decode replay
    and one prefill replay of the largest bucket (torch.profiler): each
    must run 3 × n_layers B2 kernels, and the prefill n_layers
    ``flash_fwd`` unless the model attends with MLA, where both run
    n_layers B6 calls (:func:`check_b6_replay`).  A decode replay moves
    the cache's offsets, so the profiled one starts from the same offsets
    as the call before it."""
    import torch

    params, cache, cfg = engine.params, engine.kv_cache, engine.cfg
    L = cfg.n_layers
    toks = replay_times(engine)
    pos0 = cache["pos"].clone()

    def decode_replay():
        cache["pos"].copy_(pos0)
        return engine._decode(params, cache, toks)

    b = engine.prompt_buckets[-1]
    exe, padded = engine._get_prefill_exec(b), torch.zeros((1, b), dtype=torch.long)
    seen = {"b2_in_replays": 0, "flash_in_replays": 0, "profiled_replays": 0,
            "b3_in_replays": 0, "b6_in_replays": 0}
    for name, run, shape in (
            ("decode", decode_replay, (engine.max_slots, 1, engine.max_len)),
            (f"prefill {b}", lambda: exe(params, cache, padded, 0, b), (1, b, b))):
        rows = by_kernel(kernels_in_one(run))
        if not rows:
            fail(f"one {name} graph replay: the profiler saw no device time")
        total = sum(us for us, _, _ in rows)
        b2_us = sum(us for us, _, key in rows if "stream_pack_" in key)
        b2 = sum(c for _, c, key in rows if "stream_pack_" in key)
        fl = sum(c for _, c, key in rows if "flash_fwd" in key)
        say(f"one {name} graph replay: {sum(c for _, c, _ in rows)} device ops, "
            f"{total / 1e3:.3f} ms of kernels; {b2} stream_pack kernels, {b2_us / 1e3:.3f} ms "
            f"({b2_us / total:.1%} of the kernel time); {fl} flash_fwd (torch.profiler); top:")
        for us, count, key in sorted(rows, reverse=True)[:8]:
            say(f"  {us / total:6.1%} {us / 1e3:8.3f} ms x{count:<4d} {key[:90]}")
        want_fl = L if name != "decode" and cfg.mla is None else 0
        if b2 != 3 * L or fl != want_fl:
            fail(f"a {name} replay ran {b2} stream_pack and {fl} flash kernels for {L} "
                 f"layers (want {3 * L} and {want_fl})")
        check_norm_rope(rows, cfg, f"{name} replay", again=run)
        if name == "decode":
            seen["b3_in_replays"] = check_b3_replay(rows, 0 if cfg.mla else L, "decode replay")
        if cfg.mla:
            seen["b6_in_replays"] += check_b6_replay(rows, L, b6_kernels_per_call(cfg, *shape),
                                                     f"{name} replay")
        seen["b2_in_replays"] += b2
        seen["flash_in_replays"] += fl
        seen["profiled_replays"] += 1
    return seen


def phase_moe_cpu_parity(number: int) -> None:
    """The MoE smoke configs through ``ServingEngine`` on the card and on
    the CPU, one set of weights (drawn on the card, copied over)."""
    import repro_torch.configs as C
    from repro_torch.kernels.latent_attention import kernel as b6
    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.launch import serve
    from repro_torch.models import Transformer
    from repro_torch.serving import ServingEngine

    say(f"== phase {number}: card against CPU, arctic-smoke and deepseek-v2-smoke, float32 "
        "(identical greedy tokens, and the logits of a prompt pass and of the decode step "
        "after it within 1e-3; B2 takes its float32 kernels on the card, its plain "
        "version on the CPU, and so does deepseek's MLA on B6; prompts of 8-119 tokens, "
        "buckets 16 and 128, the latter past the dropless limit of 64)")
    release()
    for arch in ("arctic-480b", "deepseek-v2-236b"):
        cfg = dataclasses.replace(C.get(arch, smoke=True), dtype="float32")
        p_gpu = serve.init_params(cfg, seed=3, device="cuda")
        p_cpu = Transformer(cfg, device="cpu")
        p_cpu.load_state_dict(p_gpu.state_dict())
        out = {}
        for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
            pack.launches = b6.launches = 0
            engine = ServingEngine(cfg, params, max_slots=4, max_len=256,
                                   bucketing=(16, 128), device=dev)
            reqs = serve.make_requests(cfg, 6, max_new=8, seed=2, min_len=8, max_len=120)
            out[dev] = {r.rid: r.generated for r in serve.serve(engine, reqs)["done"]}
            if dev == "cuda" and pack.launches == 0:
                fail(f"{cfg.name} on the card never launched stream_pack")
            if dev == "cuda" and cfg.mla:
                B6_BY_PATH["deepseek-v2-smoke f32 on the card (phase 10)"] = b6.launches
        say(f"  {cfg.name} greedy tokens cuda: {out['cuda']}")
        say(f"  {cfg.name} greedy tokens cpu:  {out['cpu']}")
        if out["cuda"] != out["cpu"]:
            fail(f"{cfg.name}: greedy tokens differ between the card and the CPU")
        err = logits_card_vs_cpu(cfg, p_gpu, p_cpu)
        say(f"  {cfg.name} logits, max |cuda - cpu|: prompt pass {err[0]:.3e}, decode step "
            f"{err[1]:.3e}")
        if not max(err) <= 1e-3:
            fail(f"{cfg.name}: logits differ by {max(err)} > 1e-3 between the card and the CPU")


def logits_card_vs_cpu(cfg, p_gpu, p_cpu) -> tuple[float, float]:
    """The largest |card - CPU| of the logits of a 48-token prompt pass,
    and of one decode step over a 64-position cache holding that prompt's
    keys (MLA's latents), each device from its own prompt pass."""
    import numpy as np
    import torch

    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models.transformer import cache_names

    P = 48
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (1, P)).astype(np.int64))
    got = {}
    with torch.no_grad():
        for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
            logits, new = prefill(params, tokens.to(dev), cfg)
            cache = init_cache(cfg, 1, 64, device=dev)
            for name, val in zip(cache_names(cfg), new):
                cache[name][:, :, :P].copy_(val)
            cache["pos"].fill_(P)
            nxt = logits[:, -1:, : cfg.vocab].argmax(-1)
            step, _ = decode_step(params, cache, nxt, cfg)
            got[dev] = (logits[..., : cfg.vocab].cpu(), step[..., : cfg.vocab].cpu(), nxt.cpu())
    if not torch.equal(got["cuda"][2], got["cpu"][2]):
        fail(f"{cfg.name}: the prompt pass's greedy token differs between the card and the CPU")
    return tuple((got["cuda"][i] - got["cpu"][i]).abs().max().item() for i in (0, 1))


# the batch decode of phases 12-14: sequences, steps, and prompt length of the
# full-sequence forward
DECODE_BATCH, DECODE_STEPS, FORWARD_LEN = 4, 16, 512


def _load(arch: str, number: int | str):
    """``arch`` at full width and depth, bf16, random weights drawn on the
    card from seed 0, after the memory of the phases before is collected."""
    import torch

    import repro_torch.configs as C
    from repro_torch.launch import serve

    release()
    cfg = dataclasses.replace(C.get(arch), dtype="bfloat16")
    t0 = time.perf_counter()
    model = serve.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in model.parameters())
    say(f"== phase {number}: {arch}, full width, {cfg.n_layers} layers"
        + (f" + {cfg.n_enc_layers} encoder layers" if cfg.n_enc_layers else "")
        + f", bf16, on the card: {n / 1e9:.3f} B parameters "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB), initialised in "
        f"{time.perf_counter() - t0:.1f}s")
    return cfg, model


def _tokens(cfg, *shape, seed: int):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, shape).astype(np.int64)).cuda()


def _clone(tree):
    import torch
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def _restore(cache, snapshot) -> None:
    from torch.utils import _pytree as pytree

    for dst, src in zip(pytree.tree_leaves(cache), pytree.tree_leaves(snapshot)):
        dst.copy_(src)


def timed_forward(model, cfg, batch, label: str, want_flash: int) -> dict:
    """One ``forward`` on the card: finite logits of the right shape, the
    flash kernel launched ``want_flash`` times (the wrapper's count); then
    its time (CUDA events, mean of 3) and the device time of one call by
    kernel (torch.profiler), B1's share among them."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import forward

    before = flash.launches
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits, _ = forward(model, batch, cfg)
        torch.cuda.synchronize()
    made = flash.launches - before
    peak = torch.cuda.max_memory_allocated() / 2**30
    S = logits.shape[1]
    if logits.shape[-1] != cfg.padded_vocab or not bool(torch.isfinite(logits).all()):
        fail(f"{label}: logits {tuple(logits.shape)} not finite or not of width {cfg.padded_vocab}")
    if made != want_flash:
        fail(f"{label}: the flash kernel launched {made} times, want {want_flash}")
    del logits
    with torch.no_grad():
        ms = time_ms(lambda: forward(model, batch, cfg), 3, warmup=1)
        rows = by_kernel(kernels_in_one(lambda: forward(model, batch, cfg)[0], check=False))
    total = sum(us for us, _, _ in rows) or float("nan")
    fl_us = sum(us for us, _, key in rows if "flash_fwd" in key)
    fl = sum(c for _, c, key in rows if "flash_fwd" in key)
    say(f"{label}: logits (.., {S}, {cfg.padded_vocab}) finite; {made} flash launches; "
        f"{ms:.3f} ms per call (CUDA events), peak {peak:.2f} GiB; one call "
        f"{total / 1e3:.3f} ms of kernels, "
        f"{fl} flash_fwd {fl_us / 1e3:.3f} ms ({fl_us / total:.1%}); top:")
    for us, count, key in sorted(rows, reverse=True)[:6]:
        say(f"  {us / total:6.1%} {us / 1e3:8.3f} ms x{count:<4d} {key[:90]}")
    return dict(ms=ms, flash=made, flash_ms=fl_us / 1e3, kernels_ms=total / 1e3, peak_gib=peak)


def batch_decode(model, cfg, make_cache, first, label: str, want_flash_per_step: int,
                 want_b3_per_step: int) -> dict:
    """``DECODE_STEPS`` greedy steps of ``decode_step`` over a batch, run
    eagerly and then as one captured CUDA graph of a step replayed (its
    token input fed from its own output), each from the state
    ``make_cache()`` gives: both must give the same tokens, in range.
    Then one replay's kernels (torch.profiler), which must hold
    ``want_flash_per_step`` flash kernels and ``want_b3_per_step`` B3
    kernels (the decoder's self attention).  Returns the times and counts."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import decode_step

    def step(cache, tok):
        logits, _ = decode_step(model, cache, tok, cfg)
        return torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)

    before = flash.launches
    with torch.no_grad():
        cache, tok, eager = make_cache(), first.clone(), []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DECODE_STEPS):
            nxt = step(cache, tok)
            eager.append(nxt)
            tok = nxt[:, None]
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / DECODE_STEPS * 1e3
        eager = torch.stack(eager, 1).cpu()

        cache = make_cache()
        snapshot = _clone(cache)
        tok_in = first.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(cache, tok_in)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        _restore(cache, snapshot)
        graph = torch.cuda.CUDAGraph()
        with capture(graph):
            out = step(cache, tok_in)
        got = []
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(DECODE_STEPS):
            graph.replay()
            got.append(out.clone())
            tok_in.copy_(out[:, None])
        stop.record()
        stop.synchronize()
        replay_ms = start.elapsed_time(stop) / DECODE_STEPS
        got = torch.stack(got, 1).cpu()
    launches = flash.launches - before
    say(f"{label}: {DECODE_STEPS} greedy steps of {first.shape[0]} sequences: eager "
        f"{eager_ms:.3f} ms a step (host clock), graph replay {replay_ms:.3f} ms a step "
        f"(CUDA events, with the token feed); {launches} flash launches (eager steps, "
        f"warm-up, capture)")
    say(f"  tokens eager {eager.tolist()}")
    say(f"  tokens graph {got.tolist()}")
    if not torch.equal(eager, got):
        fail(f"{label}: the captured step gives other tokens than the eager one")
    if eager.min() < 0 or eager.max() >= cfg.vocab:
        fail(f"{label}: a token outside [0, {cfg.vocab})")
    if launches != (DECODE_STEPS + 2) * want_flash_per_step:
        fail(f"{label}: {launches} flash launches, want "
             f"{(DECODE_STEPS + 2) * want_flash_per_step}")

    # one replay from a fixed state, profiled: its outputs must come back
    mid = _clone(cache)
    tok_mid = tok_in.clone()

    def replay():
        _restore(cache, mid)
        tok_in.copy_(tok_mid)
        graph.replay()
        return out

    rows = by_kernel(kernels_in_one(replay))
    if not rows:
        fail(f"{label}: the profiler saw no device time in a decode replay")
    total = sum(us for us, _, _ in rows)
    fl = sum(c for _, c, key in rows if "flash_fwd" in key)
    say(f"  one decode replay (after the copies that restore its state): "
        f"{sum(c for _, c, _ in rows)} device ops, {total / 1e3:.3f} ms of kernels, "
        f"{fl} flash_fwd; top:")
    for us, count, key in sorted(rows, reverse=True)[:6]:
        say(f"  {us / total:6.1%} {us / 1e3:8.3f} ms x{count:<4d} {key[:90]}")
    if fl != want_flash_per_step:
        fail(f"{label}: a decode replay ran {fl} flash kernels, want {want_flash_per_step}")
    b3 = check_b3_replay(rows, want_b3_per_step, "decode replay")
    return dict(eager_step_ms=eager_ms, replay_ms=replay_ms, flash_launches=launches,
                flash_in_replay=fl, b3_in_replay=b3, replay_kernels_ms=total / 1e3)


def phase_vlm(number: int) -> dict:
    """llava-next-34b at full width, 4 of its 60 layers: (i) served through
    ``ServingEngine`` (text prompts, as in JAX) with CUDA-graph-sealed
    steps, one prefill replay profiled (one flash kernel per layer); (ii)
    one ``forward`` of 2880 vision embeddings and a 64-token prompt, B1 at
    S = 2944, GQA 7."""
    import torch

    import repro_torch.configs as C
    from repro_torch.kernels.flash_attention import kernel as flash

    say(f"== phase {number}: serve llava-next-34b, full width, 4 layers, bf16, on the card")
    release()
    cfg = dataclasses.replace(C.get("llava-next-34b"), n_layers=4, dtype="bfloat16")
    engine, (_, served, copies, *_) = serve_on_card(cfg)
    st = engine.stats
    if served != 2 * cfg.n_layers * st.prefill_compiles or copies:
        fail(f"flash launched {served} times for {st.prefill_compiles} captured prefill "
             f"buckets (want {2 * cfg.n_layers * st.prefill_compiles}), {copies} layout copies")
    in_replay, b3_in_replay = step_breakdown(engine)
    g = torch.Generator(device="cuda").manual_seed(5)
    batch = {"tokens": _tokens(cfg, 1, 64, seed=5),
             "vision_embeds": torch.randn((1, cfg.vision_tokens, cfg.vision_dim), generator=g,
                                          device="cuda").to(torch.bfloat16)}
    flash.launches = 0
    fwd = timed_forward(engine.params, cfg, batch,
                        f"forward: {cfg.vision_tokens} vision embeddings + 64 tokens",
                        cfg.n_layers)
    return dict(served_launches=served, forward_launches=fwd["flash"],
                flash_in_replays=in_replay or 0, profiled_replays=0 if in_replay is None else 1,
                b3_in_replays=b3_in_replay, forward=fwd)


def phase_audio(number: int) -> dict:
    """seamless-m4t-medium at full width and depth: ``encode_memory`` on
    frames at the config's ratio (B1 bidirectional, hd 64), the
    teacher-forced ``forward``, then the batch decode with the memory in
    the cache (cross attention on B1 with one query row)."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import encode_memory, init_cache

    cfg, model = _load("seamless-m4t-medium", number)
    B, S = DECODE_BATCH, FORWARD_LEN
    T = S // cfg.audio_frames_ratio
    g = torch.Generator(device="cuda").manual_seed(6)
    frames = torch.randn((B, T, cfg.audio_dim), generator=g, device="cuda")
    flash.launches = 0                                     # the path's run starts here
    with torch.no_grad():
        memory = encode_memory(model, frames, cfg)
        torch.cuda.synchronize()
    if memory.shape != (B, T, cfg.d_model) or not bool(torch.isfinite(memory).all()):
        fail(f"memory {tuple(memory.shape)} not finite or not ({B}, {T}, {cfg.d_model})")
    enc = flash.launches
    with torch.no_grad():
        enc_ms = time_ms(lambda: encode_memory(model, frames, cfg), 3, warmup=1)
    say(f"encode_memory: frames ({B}, {T}, {cfg.audio_dim}) -> memory finite, {enc} flash "
        f"launches (bidirectional), {enc_ms:.3f} ms per call (CUDA events)")
    if enc != cfg.n_enc_layers:
        fail(f"encode_memory launched the flash kernel {enc} times for {cfg.n_enc_layers} layers")
    flash.launches = 0
    fwd = timed_forward(model, cfg, {"tokens": _tokens(cfg, B, S, seed=6), "frames": frames},
                        f"teacher-forced forward ({B} x {S} tokens over {T} frames)",
                        cfg.n_enc_layers + 2 * cfg.n_layers)

    def make_cache():
        cache = init_cache(cfg, B, 64, memory_len=T, device="cuda")
        cache["memory"].copy_(memory)
        return cache

    flash.launches = 0
    dec = batch_decode(model, cfg, make_cache, _tokens(cfg, B, 1, seed=7),
                       "batch decode with the memory in the cache", cfg.n_layers, cfg.n_layers)
    return dict(launches=enc + fwd["flash"] + dec["flash_launches"], encode_ms=enc_ms,
                forward=fwd, decode=dec)


def phase_recurrent(arch: str, number: int) -> dict:
    """zamba2-2.7b (hybrid) or xlstm-125m (ssm) at full width and depth:
    ``forward`` on ``DECODE_BATCH`` prompts of ``FORWARD_LEN`` tokens (the
    chunked SSD or mLSTM; zamba2's shared block on B1 at hd 80), then the
    batch decode from an empty state."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import init_cache

    cfg, model = _load(arch, number)
    B, S = DECODE_BATCH, FORWARD_LEN
    apps = cfg.n_layers // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 0
    if cfg.ssm:
        say(f"Mamba2: d_inner {cfg.ssm.expand * cfg.d_model}, state {cfg.ssm.state_dim}, "
            f"chunk {cfg.ssm.chunk}; shared attention block after every "
            f"{cfg.hybrid_attn_every}th layer ({apps} applications), "
            f"{cfg.n_heads} heads of {cfg.resolved_head_dim}")
    else:
        say(f"xLSTM: sLSTM at layers {cfg.xlstm.slstm_at}, mLSTM elsewhere (chunk "
            f"{cfg.xlstm.mlstm_chunk}), {cfg.n_heads} heads")
    flash.launches = 0                                     # the path's run starts here
    fwd = timed_forward(model, cfg, {"tokens": _tokens(cfg, B, S, seed=8)},
                        f"forward ({B} x {S} tokens)", apps)
    dec = batch_decode(model, cfg, lambda: init_cache(cfg, B, 64, device="cuda"),
                       _tokens(cfg, B, 1, seed=9), "batch decode from an empty state", 0, apps)
    return dict(launches=fwd["flash"] + dec["flash_launches"], forward=fwd, decode=dec)


@contextlib.contextmanager
def b1_calls(seen: set):
    """Add to ``seen`` the shape of every call of B1's model-layout entry
    (``kernel.attention``, which every model path calls) as (dtype, B, q
    heads, kv heads, Sq, Skv, hd, causal, scale, softcap, window); the
    calls and the wrapper's count are otherwise unchanged."""
    from repro_torch.kernels.flash_attention import kernel

    inner = kernel.attention

    def recording(q, k, v, *, scale=None, softcap=0.0, causal=True, window=0, **kw):
        seen.add((str(q.dtype)[6:], q.shape[0], q.shape[2], k.shape[2], q.shape[1],
                  k.shape[1], q.shape[3], bool(causal),
                  float(scale if scale is not None else 1.0 / math.sqrt(q.shape[3])),
                  float(softcap), int(window or 0)))
        return inner(q, k, v, scale=scale, softcap=softcap, causal=causal, window=window, **kw)

    kernel.attention = recording
    try:
        yield seen
    finally:
        kernel.attention = inner


def check_family_launches(seen: set, phases: str = "phases 11-14") -> None:
    """Fails unless every B1 call of ``phases`` (:func:`b1_calls`) was at
    a shape that phase 3 held against the plain version
    (:func:`family_cases` and :func:`long_prompt_cases`: the same dtype,
    batch, heads, lengths, head dim and mask, default scale, no cap, no
    window)."""
    checked = {(dname, B, kv * group, kv, Sq, Skv, hd, causal, 1.0 / math.sqrt(hd), 0.0, 0)
               for dname, B, hd, kv, group, Sq, Skv, causal
               in family_cases() + long_prompt_cases()}
    unchecked = sorted(seen - checked)
    if unchecked:
        fail(f"{phases} launched B1 at shapes phase 3 never checked: {unchecked}")
    say(f"{phases} called B1 at {len(seen)} shapes (dtype, B, heads, kv heads, Sq, Skv, "
        f"hd, causal), each held against the plain version in phase 3: "
        + "; ".join(" ".join(map(str, key[:8])) for key in sorted(seen)))


# forward logits of the smoke configs, card against CPU at float32 (atol,
# rtol): the two differ only in summation order (B1's float32 kernel and
# cuBLAS against the CPU's plain attention and GEMMs, TF32 off)
FAMILY_FORWARD_TOL = (1e-4, 1e-4)


def phase_families_cpu_parity(number: int) -> None:
    """The four new families' smoke configs at float32, one set of weights
    (drawn on the card, copied to the CPU): ``forward`` logits of
    ``DECODE_BATCH`` x 16 tokens (with vision embeddings or frames) within
    :data:`FAMILY_FORWARD_TOL` of the CPU's, B1 inside the model on the card
    (vlm, audio, hybrid: the shared block); then llava-next's engine on text
    prompts, and eight greedy batch-decode steps of the other three (the
    audio memory encoded on each device), identical on card and CPU."""
    import numpy as np
    import torch

    import repro_torch.configs as C
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.launch import serve
    from repro_torch.models import (Transformer, decode_step, encode_memory, forward,
                                    init_cache)
    from repro_torch.serving import ServingEngine

    say(f"== phase {number}: card against CPU, llava-next, seamless, zamba2 and xlstm smoke "
        "configs, float32 (forward logits within tolerance, identical greedy tokens; B1 on "
        "the card in the forwards, the vlm prefill and the audio cross attention, its plain "
        "version on the CPU)")
    release()
    for arch in ("llava-next-34b", "seamless-m4t-medium", "zamba2-2.7b", "xlstm-125m"):
        cfg = dataclasses.replace(C.get(arch, smoke=True), dtype="float32")
        p_gpu = serve.init_params(cfg, seed=4, device="cuda")
        p_cpu = Transformer(cfg, device="cpu")
        p_cpu.load_state_dict(p_gpu.state_dict())
        frames = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (DECODE_BATCH, 4, max(cfg.audio_dim, 1)), dtype=np.float32))
        first = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (DECODE_BATCH, 1)))
        rng = np.random.default_rng(7)
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (DECODE_BATCH, 16)))}
        if cfg.family == "vlm":
            batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
                (DECODE_BATCH, cfg.vision_tokens, cfg.vision_dim), dtype=np.float32))
        if cfg.family == "audio":
            batch["frames"] = frames
        logits = {}
        for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
            flash.launches = 0
            with torch.no_grad():
                logits[dev] = forward(params, {k: t.to(dev) for k, t in batch.items()},
                                      cfg)[0].cpu()
            if dev == "cuda" and cfg.family != "ssm" and not flash.launches:
                fail(f"{cfg.name}: forward on the card never launched the flash kernel")
        err = (logits["cuda"] - logits["cpu"]).abs().max().item()
        r = ratio(logits["cuda"], logits["cpu"], *FAMILY_FORWARD_TOL)
        say(f"  {cfg.name} forward logits {tuple(logits['cpu'].shape)}: card against CPU "
            f"max_abs_err {err:.3e} ({r:.2f} of tolerance {FAMILY_FORWARD_TOL}), max |logit| "
            f"{logits['cpu'].abs().max().item():.3e}")
        if not (bool(torch.isfinite(logits["cuda"]).all()) and r <= 1.0):
            fail(f"{cfg.name}: forward logits on the card differ from the CPU's")
        out = {}
        for dev, params in (("cuda", p_gpu), ("cpu", p_cpu)):
            flash.launches = 0
            if cfg.family == "vlm":
                engine = ServingEngine(cfg, params, max_slots=4, max_len=128,
                                       bucketing=(16, 64), device=dev)
                reqs = serve.make_requests(cfg, 6, max_new=8, seed=2, min_len=4, max_len=60)
                out[dev] = {r.rid: r.generated for r in serve.serve(engine, reqs)["done"]}
            else:
                with torch.no_grad():
                    cache = init_cache(cfg, DECODE_BATCH, 16, memory_len=frames.shape[1],
                                       device=dev)
                    if cfg.family == "audio":
                        cache["memory"].copy_(encode_memory(params, frames.to(dev), cfg))
                    tok, toks = first.to(dev), []
                    for _ in range(8):
                        logits, _ = decode_step(params, cache, tok, cfg)
                        tok = torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)[:, None]
                        toks.append(tok[:, 0].tolist())
                out[dev] = toks
            if dev == "cuda" and cfg.family in ("vlm", "audio") and not flash.launches:
                fail(f"{cfg.name} on the card never launched the flash kernel")
        say(f"  {cfg.name} greedy tokens cuda: {out['cuda']}")
        say(f"  {cfg.name} greedy tokens cpu:  {out['cpu']}")
        if out["cuda"] != out["cpu"]:
            fail(f"{cfg.name}: greedy tokens differ between the card and the CPU")


# the control plane's lanes (phases 16-18): the served phases' slots,
# positions and buckets
LANE_ENGINE = dict(max_slots=SERVE_SLOTS, max_len=1024,
                   bucketing=f"pow2:{min(PREFILL_BUCKETS)}:{max(PREFILL_BUCKETS)}")
# a dense lane's latency target (ms): generous, so admission refuses nothing
DENSE_TARGET_MS = 60_000.0


def lane_requests(cfg, n: int, seed: int, max_new: int = 16, min_len: int = 20,
                  max_len: int = 501) -> list:
    """(prompt, max_new_tokens) pairs: ``serve.make_requests``'s prompts."""
    from repro_torch.launch import serve

    return [(r.prompt, r.max_new_tokens) for r in serve.make_requests(
        cfg, n, max_new=max_new, seed=seed, min_len=min_len, max_len=max_len)]


def direct_tokens(engine, work: list) -> list:
    """Greedy tokens of ``work`` ((prompt, max_new) pairs) from ``engine``
    driven directly by ``run_until_drained``, in order."""
    from repro_torch.serving import Request

    reqs = [Request(rid=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(work)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_drained()
    return [list(r.generated) for r in reqs]


def percentile_ms(values) -> str:
    import numpy as np

    if not values:
        return "p50 - p99 -"
    v = np.asarray(values) * 1e3
    return f"p50 {np.percentile(v, 50):.2f}ms p99 {np.percentile(v, 99):.2f}ms"


def device_busy(events, wall_s: float) -> float:
    """Share of ``wall_s`` in which at least one device kernel ran: the
    union of the profiler's kernel intervals over the wall time."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6 / wall_s if wall_s > 0 else 0.0


def class_report(disp, lanes: dict, done: dict, before: dict) -> None:
    """Per class: TTFT p50/p99 over the finished requests, decode tok/s of
    the lane's engine over the run, grants, preemptions, sheds."""
    snap = disp.snapshot()
    classes = snap.get("classes", {})
    for name, (cls, engine) in lanes.items():
        reqs = done.get(name, [])
        st = engine.stats
        toks = st.tokens_out - before[name][0]
        secs = st.decode_s - before[name][1]
        c = classes.get(cls, classes.get(str(cls), {}))
        say(f"  class {cls} [{name}]: {len(reqs)} requests, TTFT "
            f"{percentile_ms([r.t_first - r.t_submit for r in reqs])}, decode "
            f"{toks / secs if secs else 0.0:.1f} tok/s, grants "
            f"{c.get('grant_ms', {}).get('count', 0)}, preemptions {c.get('preemptions', 0)}, "
            f"shed {c.get('shed', 0)}")


def dispatched_burst(disp, work: dict, *, profile_it: bool = False) -> dict:
    """Submit ``work`` ({lane: [(prompt, max_new), ...]}) interleaved across
    lanes, wait for every future; returns the finished requests by lane (in
    submission order), the wall time and, with ``profile_it``, the device
    kernels the profiler saw during the burst."""
    import contextlib as _cl

    import torch
    from torch.profiler import ProfilerActivity, profile

    order = []
    for i in range(max(len(w) for w in work.values())):
        for lane, w in work.items():
            if i < len(w):
                order.append((lane, w[i]))
    ctx = profile(activities=[ProfilerActivity.CUDA]) if profile_it else _cl.nullcontext()
    with ctx as prof:
        if profile_it:
            spin()
        t0 = time.perf_counter()
        futs = [(lane, disp.submit(lane, p, max_new_tokens=n)) for lane, (p, n) in order]
        done: dict = {lane: [] for lane in work}
        for lane, f in futs:
            done[lane].append(f.result(timeout=600))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = device_events(prof) if profile_it else []
    return {"done": done, "wall_s": wall, "events": events}


def check_lane(name: str, reqs: list, cfg, want: list | None = None, prefix: int = 0) -> None:
    """Every request finished without error with tokens in range; with
    ``want``, each request's tokens (their first ``prefix`` if given) equal
    the direct engine's."""
    import numpy as np

    for i, r in enumerate(reqs):
        if r.error or not (len(r.generated) == r.max_new_tokens or r.truncated):
            fail(f"{name} request {i}: {len(r.generated)} tokens, error {r.error}")
        toks = np.asarray(r.generated)
        if toks.min() < 0 or toks.max() >= cfg.vocab:
            fail(f"{name} request {i}: token outside [0, {cfg.vocab})")
        if want is not None:
            got = list(r.generated)[:prefix] if prefix else list(r.generated)
            if got != want[i]:
                fail(f"{name} request {i}: dispatched tokens {got} differ from the "
                     f"direct engine's {want[i]}")


def phase_dispatch(number: int) -> dict:
    """The in-process ``AsyncDispatcher`` over the port's engines on the
    card: a dense lane (phi4-mini at full width and depth, class 0, a
    latency target) and a MoE lane (deepseek-v2 at full width, 2 layers,
    class 1), bf16, one shared schedule cache; a burst of 16 mixed requests
    under per-engine steppers (profiled) and under a pool of two; then a
    third lane (phi4-mini smoke, float32, a schedule cache of one entry)
    registered while the two serve, whose requests force one evict and
    re-seal on its stepper while the others replay."""
    import numpy as np
    import torch

    import repro_torch.configs as C
    from repro_torch.core.capture import CAPTURE_LOCK
    from repro_torch.dispatch import AsyncDispatcher, ScheduleCache
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.launch import serve
    from repro_torch.serving import ServingEngine

    say(f"== phase {number}: AsyncDispatcher on the card: phi4-mini-3.8b (full, class 0, "
        f"target {DENSE_TARGET_MS:.0f}ms) + deepseek-v2-236b (full width, 2 layers, class 1), "
        "bf16; per-engine, then pool of 2; a third lane registered while they serve")
    release()
    dense_cfg = dataclasses.replace(C.get("phi4-mini-3.8b"), dtype="bfloat16")
    moe_cfg = dataclasses.replace(C.get("deepseek-v2-236b"), n_layers=2, dtype="bfloat16")
    cache = ScheduleCache(capacity=64)
    pack.launches = flash.launches = 0                  # the path's run starts here
    t0 = time.perf_counter()
    dense = ServingEngine(dense_cfg, serve.init_params(dense_cfg, seed=0, device="cuda"),
                          schedule_cache=cache, device="cuda", **LANE_ENGINE)
    moe = ServingEngine(moe_cfg, serve.init_params(moe_cfg, seed=0, device="cuda"),
                        schedule_cache=cache, device="cuda", **LANE_ENGINE)
    say(f"two lanes built and sealed in {time.perf_counter() - t0:.2f}s")
    dense_work = lane_requests(dense_cfg, 8, seed=10)
    moe_work = lane_requests(moe_cfg, 8, seed=11)
    want = direct_tokens(dense, dense_work)          # the same engine, driven directly
    lanes = {"phi4-mini": (0, dense), "deepseek-v2": (1, moe)}
    out: dict = {}

    def burst(mode: str, profiled: bool) -> dict:
        disp = AsyncDispatcher(stepping=mode, pool_size=2, max_pending=1000)
        disp.register_model("phi4-mini", dense, priority_class=0,
                            latency_target_ms=DENSE_TARGET_MS)
        disp.register_model("deepseek-v2", moe, priority_class=1)
        before = {n: (e.stats.tokens_out, e.stats.decode_s) for n, (_, e) in lanes.items()}
        replays0 = {n: (e.stats.prefill_replays, e.stats.decode_replays)
                    for n, (_, e) in lanes.items()}
        cache0 = cache.stats.as_dict()
        with disp:
            res = dispatched_burst(disp, {"phi4-mini": dense_work, "deepseek-v2": moe_work},
                                   profile_it=profiled)
            builds = disp.builds_by_stepper
        cache1 = cache.stats.as_dict()
        check_lane("phi4-mini", res["done"]["phi4-mini"], dense_cfg, want)
        check_lane("deepseek-v2", res["done"]["deepseek-v2"], moe_cfg)
        same = [list(r.generated) for r in res["done"]["deepseek-v2"]] == moe_want
        say(f"{mode}{' (profiled)' if profiled else ''}: 16 requests in {res['wall_s']:.3f}s; "
            f"phi4-mini tokens identical to the direct engine's (8 requests, bf16); "
            f"deepseek-v2 8 complete with "
            f"{sum(len(r.generated) for r in res['done']['deepseek-v2'])} tokens (same as the "
            f"direct engine's: {'yes' if same else 'no'}, not required); builds on steppers "
            f"{builds}; cache hits {cache1['hits'] - cache0['hits']}, misses "
            f"{cache1['misses'] - cache0['misses']}, evictions "
            f"{cache1['evictions'] - cache0['evictions']}")
        class_report(disp, lanes, res["done"], before)
        if any(builds.values()):
            fail(f"{mode}: a stepper sealed a step on the steady path: {builds}")
        res["pre"] = {n: e.stats.prefill_replays - replays0[n][0] for n, (_, e) in lanes.items()}
        res["dec"] = {n: e.stats.decode_replays - replays0[n][1] for n, (_, e) in lanes.items()}
        return res

    moe_want = direct_tokens(moe, moe_work)
    for mode in ("per-engine", "pool"):
        out[f"wall_{mode}"] = burst(mode, False)["wall_s"]
    # the kernels the profiler sees while the lanes serve: a session counts
    # only if it saw exactly the B1 and B2 kernels the burst's replays
    # imply (an H100 session has come back empty, another with 25 of a
    # replay's 295 kernels), and only such a session gives the busy share
    for attempt in range(1, 4):
        res = burst("per-engine", True)
        rows = by_kernel(res["events"])
        fl = sum(c for _, c, key in rows if "flash_fwd" in key)
        b2 = sum(c for _, c, key in rows if "stream_pack_" in key)
        pre, dec = res["pre"], res["dec"]
        want_fl = dense_cfg.n_layers * pre["phi4-mini"]
        want_b2 = 3 * moe_cfg.n_layers * (pre["deepseek-v2"] + dec["deepseek-v2"])
        whole = fl == want_fl and b2 == want_b2
        busy = device_busy(res["events"], res["wall_s"])
        say(f"  profiled burst {attempt}: {sum(c for _, c, _ in rows)} device kernels; flash_fwd "
            f"{fl} (want {want_fl}: {dense_cfg.n_layers} x {pre['phi4-mini']} prefill replays), "
            f"stream_pack {b2} (want {want_b2}: 3 x {moe_cfg.n_layers} x "
            f"{pre['deepseek-v2'] + dec['deepseek-v2']} replays)"
            + (f"; device busy {busy:.1%} of the burst's wall time" if whole else
               ": not the kernels the replays imply, profiling again"))
        if whole:
            break
    else:
        fail(f"no profiled burst of three saw exactly the kernels its replays imply: "
             f"flash_fwd {fl} (want {want_fl}), stream_pack {b2} (want {want_b2})")
    if not want_fl or not want_b2:
        fail(f"the dispatched lanes ran {want_fl} flash_fwd and {want_b2} stream_pack kernels "
             "in their replays: both kernels must run inside the lanes")
    out.update(flash_in_replays=fl, b2_in_replays=b2, busy=busy,
               profiled_replays=sum(pre.values()) + sum(dec.values()))

    # a third lane registered while the two serve: its seal captures CUDA
    # graphs on this thread while the steppers replay; its schedule cache
    # of one entry evicts prefill bucket 16 while it seals bucket 64, so
    # its first request re-seals bucket 16 on its stepper
    smoke_cfg = dataclasses.replace(C.get("phi4-mini-3.8b", smoke=True), dtype="float32")
    smoke_params = serve.init_params(smoke_cfg, seed=5, device="cuda")
    smoke_work = lane_requests(smoke_cfg, 6, seed=12, max_new=8, min_len=4, max_len=17)
    long_work = {"phi4-mini": [(p, 48) for p, _ in dense_work],
                 "deepseek-v2": [(p, 48) for p, _ in moe_work]}
    disp = AsyncDispatcher(stepping="per-engine", max_pending=1000)
    disp.register_model("phi4-mini", dense, priority_class=0, latency_target_ms=DENSE_TARGET_MS)
    disp.register_model("deepseek-v2", moe, priority_class=1)
    with disp:
        futs = [(lane, disp.submit(lane, p, max_new_tokens=n))
                for i in range(8) for lane, w in long_work.items() for p, n in [w[i]]]
        time.sleep(0.05)
        steps0 = dense.stats.steps + moe.stats.steps
        lock0 = CAPTURE_LOCK.stats()
        t0 = time.perf_counter()
        small = ScheduleCache(capacity=1)
        smoke = ServingEngine(smoke_cfg, smoke_params, max_slots=4, max_len=128,
                              bucketing=(16, 64), schedule_cache=small, device="cuda")
        disp.register_model("phi4-smoke", smoke, priority_class=0)
        reg_s = time.perf_counter() - t0
        steps1 = dense.stats.steps + moe.stats.steps
        lock1 = CAPTURE_LOCK.stats()
        sfuts = [disp.submit("phi4-smoke", p, max_new_tokens=n) for p, n in smoke_work]
        smoke_done = [f.result(timeout=600) for f in sfuts]
        done: dict = {"phi4-mini": [], "deepseek-v2": []}
        for lane, f in futs:
            done[lane].append(f.result(timeout=600))
        steps2 = dense.stats.steps + moe.stats.steps
        builds = disp.builds_by_stepper
    check_lane("phi4-mini", done["phi4-mini"], dense_cfg, want, prefix=16)
    check_lane("deepseek-v2", done["deepseek-v2"], moe_cfg)
    check_lane("phi4-smoke", smoke_done, smoke_cfg)
    say(f"third lane registered in {reg_s:.3f}s while the two served (their steps: {steps0} "
        f"before, {steps1} after the registration, {steps2} at the end); capture lock: "
        f"{lock1['captures'] - lock0['captures']} captures waited "
        f"{(lock1['capture_wait_s'] - lock0['capture_wait_s']) * 1e3:.2f}ms in all for replays "
        f"in flight; phi4-mini's first 16 tokens of 48 identical to the direct engine's")
    if steps2 <= steps1 or steps1 < steps0:
        fail("the two lanes did not keep stepping around the third lane's registration")
    # the host time of one uncontended shared section, which every serving
    # step's device sections pay (Nimble's graph launches take none)
    t0 = time.perf_counter()
    for _ in range(100_000):
        with CAPTURE_LOCK.replaying():
            pass
    out["shared_section_us"] = (time.perf_counter() - t0) * 10
    say(f"capture lock: one uncontended shared section takes {out['shared_section_us']:.3f} us "
        "of host time (mean of 100000)")
    say(f"forced re-seal: the one-entry cache evicted {small.stats.evictions} and built "
        f"{small.stats.builds} steps; builds on steppers {builds}")
    if builds.get("phi4-smoke") != 1 or any(v for k, v in builds.items() if k != "phi4-smoke"):
        fail(f"want exactly one build, on the third lane's stepper (the forced re-seal): {builds}")
    out["b2_launches"], out["flash_launches"] = pack.launches, flash.launches  # ... and ends here
    say(f"wrapper calls over the phase (the lanes' seals: eager warm-up runs and captures): "
        f"flash {flash.launches}, stream_pack {pack.launches}")
    if not flash.launches or not pack.launches:
        fail("a kernel of the dispatched path was never launched")

    # the dispatched float32 case of the card-against-CPU checks: the third
    # lane's requests through an AsyncDispatcher on the CPU, same weights
    from repro_torch.models import Transformer

    p_cpu = Transformer(smoke_cfg, device="cpu")
    p_cpu.load_state_dict(smoke_params.state_dict())
    cpu_engine = ServingEngine(smoke_cfg, p_cpu, max_slots=4, max_len=128,
                               bucketing=(16, 64), device="cpu")
    with AsyncDispatcher(stepping="per-engine") as cpu_disp:
        cpu_disp.register_model("phi4-smoke", cpu_engine)
        cpu_done = [f.result(timeout=600) for f in
                    [cpu_disp.submit("phi4-smoke", p, max_new_tokens=n) for p, n in smoke_work]]
    card, cpu = [list(r.generated) for r in smoke_done], [list(r.generated) for r in cpu_done]
    say(f"dispatched phi4-mini smoke, float32: card {card}")
    say(f"                                    cpu  {cpu}")
    if card != cpu:
        fail("the dispatched smoke lane's tokens differ between the card and the CPU")
    return out


def lane_spec():
    """The worker plane's and the journal's recipe: phi4-mini at full width
    and depth, bf16, seed 0, the served phases' slots and buckets."""
    from repro_torch.serving import ServingEngineSpec

    return ServingEngineSpec(arch="phi4-mini-3.8b", smoke=False, dtype="bfloat16", seed=0,
                             device="cuda", **LANE_ENGINE)


def phase_workers(number: int) -> dict:
    """``stepping="workers"``: one spawned worker process on ``cuda:0``
    builds phi4-mini from :func:`lane_spec`; its tokens must equal an
    in-process engine's built from the same spec.  Then the worker is
    SIGKILLed during a step: the requests in flight fail ``WorkerCrashed``,
    the queued ones replay on the respawned worker, token-identical."""
    import os
    import signal

    import repro_torch.configs as C
    from repro_torch.dispatch import (AsyncDispatcher, WorkerCrashed, WorkerPlane,
                                      WorkerSetupError)

    say(f"== phase {number}: the worker plane on the card: one spawned worker, phi4-mini "
        "full width, bf16, from ServingEngineSpec(smoke=False, seed=0)")
    release()
    try:
        WorkerPlane(1, device="cuda", start_method="fork").start()
        fail("a fork worker plane started after CUDA was initialised here")
    except WorkerSetupError as exc:
        say(f"fork after CUDA init refused: {exc}")
    spec = lane_spec()
    cfg = dataclasses.replace(C.get(spec.arch), dtype=spec.dtype)
    t0 = time.perf_counter()
    ref_engine = spec.build(0)
    say(f"in-process engine from the spec: {time.perf_counter() - t0:.2f}s")
    work = lane_requests(cfg, 8, seed=20)
    long_work = [(p, 400) for p, _ in lane_requests(cfg, 4, seed=21, max_len=300)]
    want = direct_tokens(ref_engine, work)

    plane = WorkerPlane(1, device="cuda", start_method="spawn", hb_interval=0.2,
                        hb_timeout=60.0, step_timeout=300.0, setup_timeout=600.0)
    disp = AsyncDispatcher(stepping="workers", worker_plane=plane, max_pending=1000)
    disp.register_model("phi4-mini", spec)
    t0 = time.perf_counter()
    out = {}
    with disp:
        ready_s = time.perf_counter() - t0
        w = disp.snapshot()["async"]["workers"]["workers"][0]
        say(f"worker pid {w['pid']} on device {w['device']} up in {ready_s:.2f}s "
            f"(spawn to ready {w['spawn_s']:.2f}s, engine build and seal {w['register_s']:.2f}s)")
        res = dispatched_burst(disp, {"phi4-mini": work})
        check_lane("phi4-mini", res["done"]["phi4-mini"], cfg, want)
        say(f"8 requests through the worker in {res['wall_s']:.3f}s: tokens identical to the "
            "in-process engine's")
        long_futs = [disp.submit("phi4-mini", p, max_new_tokens=n) for p, n in long_work]
        queued = [disp.submit("phi4-mini", p, max_new_tokens=n) for p, n in work[:4]]
        time.sleep(0.5)
        pid = disp.snapshot()["async"]["workers"]["workers"][0]["pid"]
        t_kill = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        crashed = 0
        for f in long_futs:
            try:
                f.result(timeout=600)
            except WorkerCrashed:
                crashed += 1
        replayed = [f.result(timeout=600) for f in queued]
        replay_s = time.perf_counter() - t_kill
        check_lane("phi4-mini (replayed)", replayed, cfg, want[:4])
        w = disp.snapshot()["async"]["workers"]["workers"][0]
        out["launches"] = w["stats"].get("kernel_launches", {})
        say(f"SIGKILL of pid {pid} during a step: {crashed} of 4 requests in flight failed "
            f"WorkerCrashed; the 4 queued replayed token-identical on pid {w['pid']} "
            f"({w['restarts']} restart); kill to last replayed token {replay_s:.2f}s "
            f"(respawn: spawn to ready {w['spawn_s']:.2f}s, rebuild and seal "
            f"{w['register_s']:.2f}s)")
        if crashed < 1 or w["restarts"] < 1 or w["pid"] == pid:
            fail("the kill did not crash in-flight work or the worker did not respawn")
        say(f"the worker's wrapper calls (its seals): {out['launches']}")
        if not out["launches"].get("flash_attention"):
            fail("the worker never launched the flash kernel")
    if plane.leaked():
        fail(f"worker processes outlived the plane: {plane.leaked()}")
    out.update(plane=plane, spec=spec, cfg=cfg, work=work, want=want,
               spawn_s=ready_s, respawn_s=replay_s)
    return out


def phase_journal(number: int, workers: dict) -> dict:
    """A journaled in-process run of phi4-mini (the lane's spec journaled)
    stopped with work in flight; a fresh dispatcher ``recover()``s it on
    the card — the lane rebuilt from its spec, the unfinished requests
    replayed token-identical; the recovered run's Chrome trace validates,
    and a metrics registry exposes the dispatch, cache, worker-plane and
    tracer families."""
    import tempfile

    import repro_torch.obs as obs
    from repro_torch.dispatch import AsyncDispatcher, RequestJournal
    from repro_torch.kernels.flash_attention import kernel as flash

    say(f"== phase {number}: journal and recovery on the card, trace export, metrics registry")
    release()
    spec, cfg, work, want = workers["spec"], workers["cfg"], workers["work"], workers["want"]
    want_by_prompt = {tuple(int(t) for t in p): w for (p, _), w in zip(work, want)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_journal_")
    path = f"{tmp}/journal.db"
    journal = RequestJournal(path, flush_interval=0.01)
    disp = AsyncDispatcher(stepping="per-engine", journal=journal, max_pending=1000)
    disp.register_model("phi4-mini", spec.build(0), spec=spec)
    disp.start()
    for p, n in work:
        disp.submit("phi4-mini", p, max_new_tokens=n)
    time.sleep(0.05)
    disp.stop(drain=False)                 # the crash: work left in flight
    journal.sync(timeout=10.0)
    journal.close()
    del disp
    release()

    tracer = obs.get_tracer()
    tracer.clear()
    tracer.enable()
    flash.launches = 0                      # the recovery path's run starts here
    t0 = time.perf_counter()
    journal = RequestJournal(path, flush_interval=0.01)
    disp = AsyncDispatcher(stepping="per-engine", journal=journal, max_pending=1000)
    report = disp.recover(journal)
    rebuilt_s = time.perf_counter() - t0
    with disp:
        got = {rid: f.result(timeout=600) for rid, f in report["futures"].items()}
        recover_s = time.perf_counter() - t0
        registry = obs.MetricsRegistry()
        obs.register_dispatch(registry, disp)
        obs.register_cache(registry, disp.engine("phi4-mini").schedule_cache)
        obs.register_worker_plane(registry, workers["plane"])
        obs.register_tracer(registry, tracer)
        prom = registry.to_prometheus()
    tracer.disable()
    launches = flash.launches               # ... and ends here
    journal.close()
    say(f"recovered lanes {report['lanes']}: {report['requeued']} requests requeued "
        f"({report['interrupted']} interrupted mid-step, {report['preempted']} un-granted); "
        f"lane rebuilt from its spec and sealed in {rebuilt_s:.2f}s, all replayed in "
        f"{recover_s:.2f}s")
    if report["lanes"] != ["phi4-mini"] or report["requeued"] < 1:
        fail("recovery found no lane or no unfinished request")
    for rid, r in got.items():
        w = want_by_prompt[tuple(int(t) for t in r.prompt)]
        if list(r.generated) != w:
            fail(f"recovered request {rid}: {list(r.generated)} differ from {w}")
    say(f"{len(got)} recovered requests token-identical to the in-process engine's")
    trace = obs.to_chrome_trace(tracer.drain())
    errors = obs.validate_trace(trace)
    say(f"trace of the recovered run: {len(trace['traceEvents'])} events, validate_trace "
        f"{errors}")
    if errors:
        fail(f"the recovered run's trace does not validate: {errors[:5]}")
    families = ("repro_dispatcher_", "repro_schedule_cache_", "repro_workers_", "repro_tracer_")
    missing = [f for f in families if f not in prom]
    say(f"Prometheus exposition: {len(prom.splitlines())} lines; families "
        f"{', '.join(f.rstrip('_') for f in families)} "
        + ("present" if not missing else f"MISSING {missing}"))
    if missing:
        fail(f"the metrics registry lacks {missing}")
    if not launches:
        fail("the recovered lane's seal never launched the flash kernel")
    return {"launches": launches, "recover_s": recover_s}


# ---------------------------------------------------------------------------
# phase 19: training on the card
# ---------------------------------------------------------------------------

# B1's backward (atol, rtol): float32 differs from its plain version by
# summation order (sums over up to 1024 scores of products); bf16 by the
# bf16 rounding of the three gradients (one ulp is 2**-8 relative)
BWD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
# the (group, window, softcap, causal, Sq, Skv) cases of the backward sweep,
# run at both dtypes and every head dim; (1, 16, ..., 128, 64) has fully
# masked rows (window 16 over 64 keys for 128 queries: rows 79 on see no
# key); the last three cross the 64-row and 64-key tiles' edges where the
# bf16 kernels' fragments do: GQA 7 under a window with Sq and Skv off the
# tile, a capped bidirectional Sq < Skv, and causal Sq < Skv, whose key
# tiles past Sq see no query
BWD_COMBOS = [(1, 0, 0.0, True, 64, 64), (3, 0, 0.0, True, 200, 200),
              (7, 0, 0.0, True, 128, 128), (3, 16, 0.0, True, 200, 200),
              (1, 0, 50.0, True, 130, 130), (3, 100, 50.0, False, 200, 200),
              (1, 0, 0.0, False, 77, 300), (3, 0, 0.0, False, 512, 128),
              (1, 16, 0.0, False, 128, 64), (7, 40, 0.0, True, 190, 190),
              (3, 0, 50.0, False, 100, 260), (1, 0, 0.0, True, 96, 160)]
# phi4-mini-3.8b's training step on the card: batch x sequence, eager steps
# held against as many replays from the same state, replays in all, and
# the AdamW schedule
TRAIN_BATCH, TRAIN_SEQ = 2, 512
TRAIN_EAGER, TRAIN_REPLAYS = 3, 30
# phase 21a: replays timed after the TRAIN_EAGER checked against 19c's
SHARDED_TIMED = 7
TRAIN_LR, TRAIN_WARMUP = 5e-4, 5
# the card against the CPU at float32: a step's loss and grad norm within
# TRAIN_RTOL; each parameter within TRAIN_PARAM_ATOL_LR x lr (Adam's first
# step is lr x sign(g) for most elements, and a gradient element within
# rounding of 0 may take any step in [-lr, lr])
TRAIN_RTOL, TRAIN_PARAM_ATOL_LR = 1e-4, 0.2
SMOKE_TRAIN_ARCHS = ("phi4-mini-3.8b", "arctic-480b", "deepseek-v2-236b")
# Nimble over the branchy cells' gradients: replays against eager
# torch.func element by element (as tests/test_aot_engine.py holds JAX's);
# the packed schedule's B2 sums the weight gradients' batch in another
# order than cuBLAS, where the products cancel: it is held against the
# scale of each gradient, |err| <= atol + rtol * max|ref|
GRAD_TOL = {"single_stream": (1e-5, 1e-4), "multi_stream": (1e-5, 1e-4),
            "packed": (1e-4, 1e-4)}


def _bwd_inputs(B, kv_heads, group, Sq, Skv, hd, dtype, seed, cap):
    """Model-layout q, k, v and dO on the card (q scaled up under a cap)."""
    import torch

    q, k, v = _bshd_qkv(B, kv_heads, group, Sq, Skv, hd, dtype, seed)
    if cap:
        q = q * CAP_Q_SCALE
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    do = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    return q, k, v, do


def _flat(t):
    return t.transpose(1, 2).reshape(t.shape[0] * t.shape[2], t.shape[1], t.shape[3])


def _bwd_ref(q, k, v, o, lse, do, **kw):
    """flash_attention_bwd_ref on model-layout tensors."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_ref

    grads = flash_attention_bwd_ref(_flat(q), _flat(k), _flat(v), _flat(o),
                                    lse.reshape(-1, q.shape[1]), _flat(do), **kw)
    return [g.reshape(t.shape[0], t.shape[2], t.shape[1], t.shape[3]).transpose(1, 2)
            for g, t in zip(grads, (q, k, v))]


def train_kernel_sweep() -> None:
    """19a: the forward's LSE and the backward kernel against their plain
    versions over the sweep; every kernel set of the library launched."""
    import torch

    from repro_torch.kernels.flash_attention import backward, flash_attention_lse_ref, kernel

    say(f"-- 19a: B1's backward kernel and the forward's LSE vs plain (dq, dk, dv within "
        f"atol + rtol*|ref|: {BWD_TOL}; LSE within 1e-4 + 1e-5*|ref|, +inf on the same rows; "
        "the plain backward gets the kernel's o and LSE)")
    reached, worst, n = {}, 0.0, 0
    for dname in ("float32", "bfloat16"):
        for hd in kernel.HEAD_DIMS:
            for group, window, cap, causal, Sq, Skv in BWD_COMBOS:
                B = 2 if Sq <= 200 else 1
                dtype = getattr(torch, dname)
                q, k, v, do = _bwd_inputs(B, 2, group, Sq, Skv, hd, dtype, seed=n, cap=cap)
                kw = dict(group=group, softcap=cap, causal=causal, window=window)
                o, lse = kernel.attend(q, k, v, with_lse=True, **kw)
                ref_o, ref_lse = flash_attention_lse_ref(_flat(q), _flat(k), _flat(v), **kw)
                ref_lse = ref_lse.reshape(lse.shape)
                inf = torch.isinf(ref_lse)
                if not torch.equal(inf, torch.isinf(lse)):
                    fail(f"LSE: +inf rows differ from the plain version's ({dname} hd {hd} "
                         f"{(group, window, cap, causal, Sq, Skv)})")
                lse_r = ratio(lse[~inf], ref_lse[~inf], 1e-4, 1e-5) if (~inf).any() else 0.0
                launch = backward.launch_for(q, k)
                got = backward.attention_bwd(q, k, v, o, lse, do, **kw)
                want = _bwd_ref(q, k, v, o, lse, do, **kw)
                torch.cuda.synchronize()
                reached[launch.instance] = reached.get(launch.instance, 0) + 1
                rs = [ratio(g, w, *BWD_TOL[dname]) for g, w in zip(got, want)]
                errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
                ok = all(math.isfinite(e) for e in errs) and max(rs) <= 1.0 and lse_r <= 1.0
                note = ""
                if inf.any():
                    zero = float(got[0][:, inf[0, 0].nonzero()[:, 0]].abs().max()) == 0.0
                    note = f" | {int(inf.sum())} fully masked rows, their dq 0: {zero}"
                    ok = ok and zero
                say(f"  {dname:8s} hd={hd:3d} B={B} heads={2 * group}/2 Sq={Sq:3d} Skv={Skv:3d} "
                    f"window={window:3d} cap={cap:3.0f} causal={int(causal)}: max_abs_err dq "
                    f"{errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e} (of tolerance: dq {rs[0]:.2f} dk "
                    f"{rs[1]:.2f} dv {rs[2]:.2f}) "
                    f"LSE {lse_r:.2f} of tolerance {'ok' if ok else 'FAIL'}{note}")
                if not ok:
                    fail("B1's backward kernel or the forward's LSE disagrees with the plain "
                         "version")
                worst, n = max(worst, *rs), n + 1
    missing = set(backward.INSTANCES) - set(reached)
    if missing:
        fail(f"phase 19 never launched the backward kernels {sorted(missing)}")
    say(f"  {n} cases within tolerance (worst at {worst:.2f}); cases by kernel set "
        f"(dtype, hd): {dict(sorted(reached.items()))}")


# the backward's three kernels, by the name each has in a profile
BWD_KERNELS = ("bwd_dot", "bwd_dkdv", "bwd_dq")


def bwd_registers() -> dict:
    """Registers and spill bytes (stores, loads) of each backward kernel
    from ptxas's report in the build log, by (kernel, dtype, hd)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import backward

    out, entry = {}, None
    for line in build.build_log(backward.SOURCE).splitlines():
        if "Compiling entry" in line:
            found = re.search(r"(bwd_dot|bwd_dkdv_bf16|bwd_dkdv_f32|bwd_dq_bf16|bwd_dq_f32)"
                              r"I?(\w*?)Li(\d+)E", line)
            entry = None
            if found:
                kind, dot_type, hd = found.groups()
                dtype = ("bf16" if "bfloat16" in dot_type else "f32") if kind == "bwd_dot" \
                    else kind.rsplit("_", 1)[1]
                entry = (kind.replace("_bf16", "").replace("_f32", ""), dtype, int(hd))
                out[entry] = {}
        elif entry is not None and "spill stores" in line:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            out[entry]["spills"] = (int(st), int(ld))
        elif entry is not None and "Used" in line and "registers" in line:
            out[entry]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


# ptxas's notes that it serialized a kernel's wgmma
SERIALIZING = ("C7510", "C7512", "C7515", "C7520")


def ptxas_report(logs, name_in) -> dict:
    """Registers, spill bytes (stores, loads) and whether ptxas serialized
    its ``wgmma`` (a C75xx note that says so: for want of registers, C7510
    or C7512, or for a fence the compiler put in a divergent path, C7515 or
    C7520; C7519, a ``warpgroup.arrive`` it injected, is not one) of each
    kernel of ptxas's reports ``logs`` that ``name_in(line)`` names."""
    out, serialized = {}, set()
    for log in logs:
        entry = None
        for line in log.splitlines():
            if ("serialized" in line or any(c in line for c in SERIALIZING)) and name_in(line):
                serialized.add(name_in(line))
            elif "Compiling entry" in line:
                entry = name_in(line) or None
                if entry:
                    out[entry] = {}
            elif entry is not None and "spill stores" in line:
                st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                   line).groups()
                out[entry]["spills"] = (int(st), int(ld))
            elif entry is not None and "Used" in line and "registers" in line:
                out[entry]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    for name, rec in out.items():
        rec["serialized"] = name in serialized
    return out


def latent_registers(log: str | None = None) -> dict:
    """:func:`ptxas_report` of B6's kernels (``log``, or the build log of
    ``latent_attention.cu``), by name: ``latent_attention_kernel<NCH>``
    (the bf16 kernel at latent widths up to 128 NCH), ``latent_combine``,
    ``latent_attention_f32``."""
    from repro_torch.kernels import build
    from repro_torch.kernels.latent_attention import kernel as b6

    def name_in(line):
        found = re.search(r"(latent_attention_kernel|latent_combine|latent_attention_f32)"
                          r"(?:ILi(\d+)E)?", line)
        return found and (f"{found[1]}<{found[2]}>" if found[2] else found[1])

    return ptxas_report([build.build_log(b6.SOURCE) if log is None else log], name_in)


def bwd_kernel_ms(call, reps: int = 5, attempts: int = 4) -> tuple[dict, int]:
    """Each backward kernel's device time in ms under the profiler over
    ``reps`` calls of ``call`` (one backward each), and the number of
    calls it is the mean of: the calls the profiler recorded whole, a
    ``bwd_dot``, ``bwd_dkdv``, ``bwd_dq`` run in launch order (sessions on
    the card come back without their first kernels).  Up to ``attempts``
    readings until one holds a whole call."""
    for _ in range(attempts):
        events = kernels_in_one(lambda: [call() for _ in range(reps)])
        mine = sorted((e for e in events if any(n in e.name for n in BWD_KERNELS)),
                      key=lambda e: e.time_range.start)
        kinds = [next(n for n in BWD_KERNELS if n in e.name) for e in mine]
        whole = [mine[i:i + 3] for i in range(len(mine) - 2)
                 if tuple(kinds[i:i + 3]) == BWD_KERNELS]
        if whole:
            return {name: sum(run[j].time_range.elapsed_us() for run in whole) / len(whole) / 1e3
                    for j, name in enumerate(BWD_KERNELS)}, len(whole)
        say(f"    (the profiler recorded no whole backward call of {reps}: {len(mine)} of its "
            "kernels; profiling again)")
    fail(f"no profiler reading held a whole backward call in {attempts} attempts")


def train_kernel_timing() -> dict:
    """19a: the backward kernel at phi4-mini's training shape (q (2, 512,
    24, 128), k/v (2, 512, 8, 128), bf16, causal): two calls on the same
    inputs must give the same bits; then its time in a CUDA graph and from
    Python, each of its three kernels' device time from the profiler, its
    registers and spills, beside its plain version, its bound and the
    library's forward + backward (a yardstick only)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import backward, kernel

    B, NH, NKV, S, hd = TRAIN_BATCH, 24, 8, TRAIN_SEQ, 128
    q, k, v, do = _bwd_inputs(B, NKV, NH // NKV, S, S, hd, torch.bfloat16, seed=900, cap=0.0)
    kw = dict(group=NH // NKV, causal=True)
    o, lse = kernel.attend(q, k, v, with_lse=True, **kw)
    copies = kernel.layout_copies
    got = backward.attention_bwd(q, k, v, o, lse, do, **kw)
    again = backward.attention_bwd(q, k, v, o, lse, do, **kw)
    copies = kernel.layout_copies - copies
    want = _bwd_ref(q, k, v, o, lse, do, **kw)
    r = max(ratio(g, w, *BWD_TOL["bfloat16"]) for g, w in zip(got, want))
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    say(f"-- 19a at phi4-mini's training shape: {r:.3f} of tolerance, max_abs_err {err:.3e}; two "
        f"calls on the same inputs bit-identical (dq, dk, dv): {same}; layout copies {copies}")
    if not r <= 1.0:
        fail(f"the backward kernel disagrees at phi4-mini's training shape: {r:.3f} of tolerance")
    if not same:
        fail("two calls of the backward kernel on the same inputs differ: it is not deterministic")
    if copies:
        fail(f"the backward copied {copies} of phi4-mini's contiguous inputs")
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    dos = do.transpose(1, 2)

    def library():
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
        return torch.autograd.grad(out, (qs, ks, vs), dos)

    calls = {"kernel": lambda: backward.attention_bwd(q, k, v, o, lse, do, **kw),
             "plain": lambda: _bwd_ref(q, k, v, o, lse, do, **kw),
             "library": library}
    graphed = {name: graph_ms(fn, reps=5 if name == "plain" else 10,
                              iters=5 if name == "plain" else 20) for name, fn in calls.items()}
    eager = {name: time_ms(fn, 5 if name == "plain" else 20) for name, fn in calls.items()}
    # five products over the visible (query, key) pairs: S and dP
    # recomputed, dV, dK, dQ; 2 operations per multiply-add
    flops = 2 * 5 * hd * NH * B * sum(min(i + 1, S) for i in range(S))
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + o.numel() + do.numel()
                  + q.numel() + k.numel() + v.numel()) + 4 * 2 * lse.numel()
    bound_ms, bound_by = bound(flops, nbytes, "bfloat16")
    ops_ms, bytes_ms = bound(flops, 0, "bfloat16")[0], bound(0, nbytes, "bfloat16")[0]
    launch = backward.launch_for(q, k)
    regs = bwd_registers()
    say(f"-- 19a timing, q ({B},{S},{NH},{hd}) kv ({B},{S},{NKV},{hd}) bf16 causal: graph "
        f"kernel_ms {graphed['kernel']:.5f} plain_ms {graphed['plain']:.5f} library_ms (SDPA "
        f"forward + backward) {graphed['library']:.5f} | eager kernel_ms {eager['kernel']:.5f} "
        f"plain_ms {eager['plain']:.5f} library_ms {eager['library']:.5f} | bound_ms "
        f"{bound_ms:.5f} ({bound_by}; operations {ops_ms:.5f}: {flops / 1e9:.3f} GFLOP at "
        f"the bf16 peak, 2.5x the forward's; bytes {bytes_ms:.5f}) | kernel at "
        f"{bound_ms / graphed['kernel']:.1%} of bound | grids dot "
        f"{launch.dot_grid} dkdv {launch.dkdv_grid} dq {launch.dq_grid}, {launch.threads} "
        f"threads, smem dkdv {launch.dkdv_smem} dq {launch.dq_smem} B | max_abs_err {err:.3e}")
    say("  registers and spill bytes (stores, loads) from ptxas, by (kernel, dtype, hd): "
        + "; ".join(f"{k[0]} {k[1]} hd {k[2]}: {v.get('registers')} regs, spills "
                    f"{v.get('spills')}" for k, v in sorted(regs.items())))
    if any(regs.get((name, "bf16", hd), {}).get("registers") is None
           for name in BWD_KERNELS for hd in kernel.HEAD_DIMS):
        fail("the build log has no ptxas register report for every bf16 backward kernel")
    reps = 5
    per_kernel, seen = bwd_kernel_ms(
        lambda: backward.attention_bwd(q, k, v, o, lse, do, **kw), reps)
    # would more dK/dV CTAs help?  One CTA per (q head, key tile) is the
    # dK/dV kernel at 24 kv heads of group 1: three times the CTAs, a third
    # of the query tiles each (the partial sums over the group it would
    # need are not run)
    q1, k1, v1, do1 = _bwd_inputs(B, NH, 1, S, S, hd, torch.bfloat16, seed=901, cap=0.0)
    o1, lse1 = kernel.attend(q1, k1, v1, with_lse=True, causal=True)
    per_q_head = bwd_kernel_ms(
        lambda: backward.attention_bwd(q1, k1, v1, o1, lse1, do1, causal=True),
        reps)[0]["bwd_dkdv"]
    del q1, k1, v1, do1, o1, lse1
    say(f"  each kernel's device time (profiler, mean of the {seen} of {reps} eager calls "
        "it recorded whole): "
        + ", ".join(f"{name} {ms:.5f} ms" for name, ms in per_kernel.items())
        + f"; bwd_dkdv with one CTA per (q head, key tile) instead (24 kv heads of group 1, "
        f"grid ({B * NH}, {S // 64}), no partial sums): {per_q_head:.5f} ms")
    forward = train_forward_timing(q, k, v, o, lse, kw)
    return dict(max_abs_err=err, ms=graphed["kernel"], plain_ms=graphed["plain"],
                bound_ms=bound_ms, bound_by=bound_by, library_ms=graphed["library"],
                library_is="F.scaled_dot_product_attention forward + backward",
                forward_with_lse=forward,
                eager_ms=eager["kernel"], eager_library_ms=eager["library"],
                kernel_ms_by_kernel=per_kernel, dkdv_ms_per_q_head_ctas=per_q_head,
                deterministic=same, layout_copies=copies,
                registers={f"{k[0]} {k[1]} hd{k[2]}": v.get("registers")
                           for k, v in sorted(regs.items())})


def train_forward_timing(q, k, v, o, lse, kw) -> dict:
    """19a: B1's forward with the rows' LSE at phi4-mini's training shape,
    the call a training step makes: against its plain version, its time in
    a CUDA graph and from Python beside the plain version, the library's
    forward (a yardstick only) and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_lse_ref

    B, S, NH, hd = q.shape
    flat = [_flat(t) for t in (q, k, v)]
    want_o, want_lse = flash_attention_lse_ref(*flat, **kw)
    err = (_flat(o).float() - want_o.float()).abs().max().item()
    lse_err = (lse.reshape(-1, S) - want_lse).abs().max().item()
    r = ratio(_flat(o), want_o, *TOL["bfloat16"])
    # the LSE under the tolerance 19a's sweep holds it to
    lse_r = ratio(lse.reshape(-1, S), want_lse, 1e-4, 1e-5)
    if not (r <= 1.0 and lse_r <= 1.0):
        fail(f"B1's forward with LSE disagrees at phi4-mini's training shape: {r:.3f} of "
             f"tolerance, LSE {lse_r:.3f} of tolerance")
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    calls = {"kernel": lambda: kernel.attend(q, k, v, with_lse=True, **kw),
             "plain": lambda: flash_attention_lse_ref(*flat, **kw),
             "library": lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                               enable_gqa=True)}
    graphed = {name: graph_ms(fn, reps=5 if name == "plain" else 10,
                              iters=5 if name == "plain" else 20) for name, fn in calls.items()}
    eager = {name: time_ms(fn, 5 if name == "plain" else 20) for name, fn in calls.items()}
    # two products over the visible (query, key) pairs; q, k, v read once,
    # o and the float32 LSE written once
    flops = 2 * 2 * hd * NH * B * sum(min(i + 1, S) for i in range(S))
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + o.numel()) + 4 * lse.numel()
    bound_ms, bound_by = bound(flops, nbytes, "bfloat16")
    say(f"-- 19a B1's forward with LSE, q ({B},{S},{NH},{hd}) kv {tuple(k.shape)} bf16 causal: "
        f"{r:.3f} of tolerance, max_abs_err {err:.3e}, LSE {lse_err:.3e} | graph kernel_ms "
        f"{graphed['kernel']:.5f} plain_ms {graphed['plain']:.5f} library_ms (SDPA forward, "
        f"no LSE) {graphed['library']:.5f} | eager kernel_ms {eager['kernel']:.5f} plain_ms "
        f"{eager['plain']:.5f} library_ms {eager['library']:.5f} | bound_ms {bound_ms:.5f} "
        f"({bound_by}, {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB) | kernel at "
        f"{bound_ms / graphed['kernel']:.1%} of bound")
    return dict(max_abs_err=err, ms=graphed["kernel"], plain_ms=graphed["plain"],
                library_ms=graphed["library"], bound_ms=bound_ms, bound_by=bound_by,
                eager_ms=eager["kernel"])


def train_b2_backward() -> dict:
    """19b: B2's two backward products (through ``StreamPack``) against
    the plain version at the smoke experts' shapes (the capacities of the
    19d step), a shared x, and a full deepseek-v2 expert shape at M 64 and
    at its training capacity (``TRAIN_EXPERT_M``, the wgmma kernel's), each
    timed beside two ``torch.bmm`` (a yardstick only).  The products read
    w^T and x^T where they lie: ``layout_copies`` must stay 0."""
    import torch

    import repro_torch.configs as C
    from repro_torch.kernels.stream_pack import kernel as pack, stream_pack
    from repro_torch.models.moe import capacity, moe_shapes

    say(f"-- 19b: B2's backward products dx = dy w^T and dw = x^T dy vs plain (within "
        f"{PACK_TOL}), by the StreamPack autograd Function, w^T and x^T read where they lie")
    cases = []
    for arch in SMOKE_TRAIN_ARCHS[1:]:
        cfg = C.get(arch, smoke=True)
        E, D, Fx = moe_shapes(cfg)["w_gate"]
        M = capacity(TRAIN_BATCH * 64, cfg)
        cases += [(f"{arch} smoke gate/up", "float32", E, M, D, Fx, False),
                  (f"{arch} smoke down", "float32", E, M, Fx, D, False)]
    cases += [("branchy shared x", "float32", 7, 64, 64, 64, True),
              ("deepseek-v2 full expert", "bfloat16", 160, 64, 5120, 1536, False),
              (f"deepseek-v2 full expert M {TRAIN_EXPERT_M}", "bfloat16", 160, TRAIN_EXPERT_M,
               5120, 1536, False)]
    record = {}
    copies = pack.layout_copies
    for label, dname, lanes, M, K, N, shared in cases:
        dtype = getattr(torch, dname)
        g = torch.Generator(device="cuda").manual_seed(lanes + M + K)
        x = torch.randn((M, K) if shared else (lanes, M, K), generator=g, device="cuda").to(dtype)
        w = (torch.randn((lanes, K, N), generator=g, device="cuda") / math.sqrt(K)).to(dtype)
        dy = torch.randn((lanes, M, N), generator=g, device="cuda").to(dtype)
        xg, wg = x.requires_grad_(True), w.requires_grad_(True)
        before = pack.launches
        y = stream_pack(xg, wg)
        dx, dw = torch.autograd.grad(y, (xg, wg), dy)
        torch.cuda.synchronize()
        if pack.launches - before != 3:
            fail(f"{label}: forward and backward made {pack.launches - before} B2 launches, not 3")
        xd, wd = x.detach(), w.detach()
        xs = xd.expand(lanes, M, K) if shared else xd
        variants = (pack.launch_for(dy, wd.transpose(1, 2)).variant,
                    pack.launch_for(xs.transpose(1, 2), dy).variant)
        rx = rw = 0.0
        for lo in range(0, lanes, REF_LANES):        # the plain version a few lanes at a time
            hi = min(lanes, lo + REF_LANES)
            dyf, wf = dy[lo:hi].float(), w[lo:hi].detach().float()
            xf = x.detach().float() if shared else x[lo:hi].detach().float()
            rw = max(rw, ratio(dw[lo:hi], xf.transpose(-2, -1) @ dyf, *PACK_TOL[dname]))
            if not shared:
                rx = max(rx, ratio(dx[lo:hi], dyf @ wf.transpose(1, 2), *PACK_TOL[dname]))
        if shared:
            rx = ratio(dx, (dy.float() @ w.detach().float().transpose(1, 2)).sum(0),
                       *PACK_TOL[dname])
        say(f"  {label}: lanes {lanes} M {M} K {K} N {N} {dname}: dx {rx:.2f} and dw {rw:.2f} "
            f"of tolerance; dx on {variants[0]}, dw on {variants[1]}")
        if not max(rx, rw) <= 1.0:
            fail(f"{label}: B2's backward disagrees with the plain version")
        if label.startswith("deepseek-v2 full expert"):
            from repro_torch.kernels.stream_pack.ops import _stream_pack

            def kern():
                return _stream_pack(dy, wd.transpose(1, 2)), _stream_pack(xd.transpose(1, 2), dy)

            def lib():
                return torch.bmm(dy, wd.transpose(1, 2)), torch.bmm(xd.transpose(1, 2), dy)

            ms, lib_ms, eager_ms = graph_ms(kern, reps=5, iters=10), graph_ms(lib, 5, 10), \
                time_ms(kern, 10)
            dx_ms = graph_ms(lambda: _stream_pack(dy, wd.transpose(1, 2)), 5, 10)
            dw_ms = graph_ms(lambda: _stream_pack(xd.transpose(1, 2), dy), 5, 10)
            nbytes = 2 * (x.numel() + 2 * w.numel() + dy.numel() + x.numel())
            flops = 2 * 2 * lanes * M * K * N
            bound_ms, _ = bound(flops, nbytes, "bfloat16")
            say(f"    timed (graph): both products, no copy, {ms:.4f} ms (eager {eager_ms:.4f}); "
                f"dx alone {dx_ms:.4f}, dw alone {dw_ms:.4f}; two torch.bmm {lib_ms:.4f} ms; "
                f"bound {bound_ms:.4f} ms (bytes); kernel at {bound_ms / ms:.1%} of bound, "
                f"{lib_ms / ms:.3f}x the library's speed")
            key = "backward" if M == 64 else f"backward_m{M}"
            record.update({f"{key}_ms": ms, f"{key}_eager_ms": eager_ms, f"{key}_dx_ms": dx_ms,
                           f"{key}_dw_ms": dw_ms, f"{key}_library_ms": lib_ms,
                           f"{key}_bound_ms": bound_ms, f"{key}_shape": [lanes, M, K, N],
                           f"{key}_variants": list(variants)})
        del x, w, dy, y, dx, dw, xg, wg
    made = pack.layout_copies - copies
    say(f"  B2 layout copies over 19b: {made}")
    if made:
        fail(f"19b: B2's backward made {made} layout copies of w or x")
    record["backward_layout_copies"] = made
    return record


# 19f: B4 (AdamW) against its plain version on the card, three steps a
# case from one state: (label, leaf sizes, dtype, max_grad_norm, lr form,
# base offset in elements).  The sizes: odd ones (a lone element, a tail
# shorter than a vector, phi4-mini's norm scale 3072, a tail past a whole
# vector, a tail past 2^20) and phi4-mini's MLP matrix and embedding; the
# clip active (1.0), off (0.0) and not reached (1e3); lr a float and a
# device tensor; a base one element past 16 bytes (every tree a view)
ADAMW_ODD = (1, 5, 3072, 4097, 2**20 + 3)
ADAMW_PHI4 = (25_165_824, 614_989_824)
ADAMW_CLIPS = (1.0, 0.0, 1e3)
ADAMW_CASES = [(f"{dt} clip {clip:g} lr {lr}", ADAMW_ODD, dt, clip, lr, 0)
               for dt in ("bfloat16", "float32") for clip in ADAMW_CLIPS
               for lr in ("float", "tensor")] + [
    ("bfloat16 off 16 bytes", ADAMW_ODD[1:], "bfloat16", 1.0, "tensor", 1),
    ("float32 off 16 bytes", ADAMW_ODD[1:], "float32", 1e3, "float", 1),
    ("bfloat16 phi4-mini's MLP matrix and embedding", ADAMW_PHI4, "bfloat16", 1.0, "tensor", 0),
    ("float32 phi4-mini's MLP matrix", ADAMW_PHI4[:1], "float32", 0.0, "float", 0),
]
ADAMW_STEPS = 3
# Tolerances of 19f, from the kernel's rounding (csrc/adamw.cu: every
# operation of the update rounds once, no FMA contraction; the plain
# version's add_(alpha) and addcmul_ may fuse a product into an FMA on the
# card):
# * each moment within ADAMW_MOMENT_RTOL (about four float32 ulps) of its
#   terms' magnitude, |b·m| + |(1 - b)·g| (|b·v| + |(1 - b)·g·g|);
# * a float32 parameter within ADAMW_F32_PARAM_RTOL of |p| + |p - p'|,
#   plus the first moment's tolerance carried through the update,
#   lr·(ADAMW_MOMENT_RTOL·|terms| / bc1) / (sqrt(v'/bc2) + eps), which
#   sets the bound where the first moment cancels (|m'| far below its
#   terms);
# * a bf16 parameter equal, or one bf16 ulp of |p'| apart where the plain
#   version's float32 p2 lies within the float32 tolerance above of the
#   rounding midpoint of its bf16 interval (the share that is bit-identical
#   is printed; a store that truncates, say, fails far from any midpoint);
# * each leaf's sum of squares and the norm within ADAMW_SUM_RTOL (two
#   summation trees over up to 615 M squares, 4.45 B in the timed tree);
# * the clip scale and the bias corrections within ADAMW_SCALAR_RTOL (one
#   division; the kernel's powf against torch.pow).
# The step is held on the kernel's own scalars, the norm and the scale on
# their own.
ADAMW_MOMENT_RTOL, ADAMW_F32_PARAM_RTOL = 5e-7, 1e-6
ADAMW_SUM_RTOL, ADAMW_SCALAR_RTOL = 1e-5, 1e-6
ADAMW_HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
ADAMW_LR = 1e-3
# the largest |parameter - plain| of each adamw_check run (the kernels line)
ADAMW_ERR: list = []


def _adamw_leaf(numel, dtype, offset, gen, scale):
    """A 1-d tensor of ``numel`` normal values times ``scale`` in
    ``dtype``, its base ``offset`` elements into its storage."""
    import torch

    store = torch.empty(numel + offset, dtype=dtype, device="cuda")
    out = store[offset:]
    out.copy_(torch.randn(numel, generator=gen, device="cuda").mul_(scale))
    return out


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def adamw_check(cases=ADAMW_CASES) -> list[str]:
    """19f's check: each case's trees through B4 (``adamw_sumsq``,
    ``adamw_finish``, ``adamw_step``) and through the plain versions from
    the same state, ``ADAMW_STEPS`` steps, the plain state set to the
    kernel's after each.  Prints each case's share of every tolerance;
    returns the labels of the cases that failed."""
    import torch

    from repro_torch.kernels.adamw import kernel as b4
    from repro_torch.kernels.adamw.ref import (adamw_step_ref, bias_corrections_ref,
                                               norm_scale_ref, sumsq_ref)

    failed = []
    worst_abs = 0.0
    for c, (label, sizes, dname, clip, lr_form, offset) in enumerate(cases):
        dtype = getattr(torch, dname)
        gen = torch.Generator(device="cuda").manual_seed(100 + c)
        params = [_adamw_leaf(n, dtype, offset, gen, 1.0) for n in sizes]
        mus = [_adamw_leaf(n, torch.float32, offset, gen, 1e-2) for n in sizes]
        nus = [_adamw_leaf(n, torch.float32, offset, gen, 1e-2).abs_() for n in sizes]
        step = torch.zeros((), dtype=torch.int32, device="cuda")
        worst = dict(sums=0.0, norm=0.0, scale=0.0, bc=0.0, m=0.0, v=0.0, p=0.0, mid=0.0)
        same = total = 0
        for s in range(ADAMW_STEPS):
            grads = [_adamw_leaf(n, dtype, offset, gen, 0.5) for n in sizes]
            lr = (ADAMW_LR * (s + 1) if lr_form == "float"
                  else torch.full((), ADAMW_LR * (s + 1), device="cuda"))
            plain = [t.clone() for t in params], [t.clone() for t in mus], \
                [t.clone() for t in nus]
            pstep = step.clone()
            buf = b4.adamw_sumsq(grads)
            sums = buf[:len(sizes)]
            scalars = b4.adamw_finish(buf, step, max_norm=clip, b1=ADAMW_HYPER["b1"],
                                      b2=ADAMW_HYPER["b2"])
            ref_sums = sumsq_ref(grads)
            norm, scale = norm_scale_ref(ref_sums, clip)
            bc1, bc2 = bias_corrections_ref(pstep, ADAMW_HYPER["b1"], ADAMW_HYPER["b2"])
            worst["sums"] = max(worst["sums"], max(_rel(a, b) for a, b in zip(sums, ref_sums))
                                / ADAMW_SUM_RTOL)
            worst["norm"] = max(worst["norm"], _rel(scalars[0], norm) / ADAMW_SUM_RTOL)
            worst["scale"] = max(worst["scale"], _rel(scalars[1], scale) / ADAMW_SCALAR_RTOL)
            worst["bc"] = max(worst["bc"], _rel(scalars[2], bc1) / ADAMW_SCALAR_RTOL,
                              _rel(scalars[3], bc2) / ADAMW_SCALAR_RTOL)
            if int(step) != int(pstep) or int(step) != s + 1:
                worst["bc"] = math.inf
            b4.adamw_step(grads, mus, nus, params, scalars, lr, clip=bool(clip), **ADAMW_HYPER)
            for g, m, v, p, pp, pm, pv in zip(grads, mus, nus, params, *plain):
                gc = (g * scalars[1].to(dtype) if clip else g).float()
                m_mag = pm.abs().mul_(ADAMW_HYPER["b1"]).add_(gc.abs(),
                                                              alpha=1 - ADAMW_HYPER["b1"])
                p_old = pp.to(torch.float32, copy=True)
                # the plain version on a float32 copy of a bf16 parameter
                # gives its float32 p2 unrounded; it rounds to bf16 just as
                # adamw_step_ref's own copy_ does (to nearest, ties to even)
                p2 = p_old.clone() if dname == "bfloat16" else pp
                adamw_step_ref(g, pm, pv, p2, scale=scalars[1] if clip else None, lr=lr,
                               bc1=scalars[2], bc2=scalars[3], **ADAMW_HYPER)
                if dname == "bfloat16":
                    pp.copy_(p2)
                m_tol = m_mag.mul_(ADAMW_MOMENT_RTOL)
                worst["m"] = max(worst["m"], ((m - pm).abs() / (m_tol + 1e-30)).max().item())
                # the first moment's tolerance carried into the parameter
                carried = m_tol.div_(scalars[2]).div_(
                    (pv / scalars[3]).sqrt_().add_(ADAMW_HYPER["eps"])).mul_(lr)
                del m_mag, gc
                worst["v"] = max(worst["v"], ((v - pv).abs() / pv.abs().mul_(ADAMW_MOMENT_RTOL)
                                              .add_(1e-30)).max().item())
                diff = (p.float() - pp.float()).abs()
                worst_abs = max(worst_abs, diff.max().item())
                # float32's tolerance of p2
                lim = p_old.abs().add_((p_old - p2).abs()).mul_(ADAMW_F32_PARAM_RTOL) \
                    .add_(carried).add_(1e-30)
                if dname == "bfloat16":
                    exp = torch.frexp(pp.float())[1]
                    ulp = torch.ldexp(torch.ones_like(diff), exp - 8)
                    worst["p"] = max(worst["p"], (diff / ulp).max().item())
                    # a bf16 parameter may differ only where p2 lies within
                    # float32's tolerance of the rounding midpoint of its
                    # bf16 interval (bits: the low 16 of p2 = 0x8000)
                    mid = (p2.view(torch.int32) & -65536 | 0x8000).view(torch.float32)
                    off = (p2 - mid).abs_().div_(lim)
                    worst["mid"] = max(worst["mid"], torch.where(diff > 0, off, 0.0).max().item())
                    same += int((p == pp).sum())
                    total += p.numel()
                    del exp, ulp, mid, off
                else:
                    worst["p"] = max(worst["p"], (diff / lim).max().item())
                del diff, p_old, p2, lim, carried, m_tol
                pm.copy_(m)
                pv.copy_(v)
                pp.copy_(p)
            del grads, plain
        torch.cuda.synchronize()
        bits = (f"; bf16 parameters bit-identical {same / total:.6%}, the others' distance "
                f"to a rounding midpoint {worst['mid']:.3f} of tolerance" if total else "")
        ok = max(worst.values()) <= 1.0
        say(f"  {label}: {len(sizes)} leaves of {', '.join(map(str, sizes))}, base +{offset}, "
            f"{ADAMW_STEPS} steps: of tolerance sums {worst['sums']:.3f}, norm "
            f"{worst['norm']:.3f}, scale {worst['scale']:.3f}, bias corrections "
            f"{worst['bc']:.3f}, m {worst['m']:.3f}, v {worst['v']:.3f}, p "
            f"{worst['p']:.3f}{bits}{'' if ok else '  <-- FAILS'}")
        if not ok:
            failed.append(label)
        del params, mus, nus
    say(f"  largest |parameter - plain| over the cases: {worst_abs:.3e}")
    ADAMW_ERR.append(worst_abs)
    return failed


def phi4_leaves():
    """(shape, dtype) of phi4-mini-3.8b's 291 parameters at bf16 (the norm
    scales float32), in the model's order, from a model on the meta
    device."""
    import repro_torch.configs as C
    from repro_torch.models import Transformer

    cfg = dataclasses.replace(C.get("phi4-mini-3.8b"), dtype="bfloat16")
    return [(tuple(p.shape), p.dtype) for p in Transformer(cfg, device="meta").parameters()]


def adamw_timing() -> dict:
    """19f's timing: B4 over phi4-mini's 291 leaves (4.45 B parameters)
    in a CUDA graph, the sum of squares with the finish and the update
    apart and together, beside the plain version, the bound and the
    library (``torch._foreach_norm`` and ``torch._fused_adamw_``, a
    yardstick only)."""
    import torch

    from repro_torch.kernels.adamw import kernel as b4
    from repro_torch.kernels.adamw.ref import (adamw_step_ref, bias_corrections_ref,
                                               norm_scale_ref, sumsq_ref)

    leaves = phi4_leaves()
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = [torch.randn(s, generator=gen, device="cuda").to(d) for s, d in leaves]
    grads = [torch.randn(s, generator=gen, device="cuda").mul_(1e-3).to(d) for s, d in leaves]
    mus = [torch.randn(s, generator=gen, device="cuda").mul_(1e-3) for s, _ in leaves]
    nus = [torch.randn(s, generator=gen, device="cuda").mul_(1e-3).square_() for s, _ in leaves]
    step = torch.zeros((), dtype=torch.int32, device="cuda")
    lr = torch.full((), ADAMW_LR, device="cuda")
    n = sum(p.numel() for p in params)

    def norm():
        return b4.adamw_finish(b4.adamw_sumsq(grads), step, max_norm=1.0)

    def kern():
        b4.adamw_step(grads, mus, nus, params, norm(), lr, clip=True, **ADAMW_HYPER)

    scalars = norm()
    ref = norm_scale_ref(sumsq_ref(grads), 1.0)[0]
    norm_r = _rel(scalars[0], ref) / ADAMW_SUM_RTOL
    say(f"  phi4-mini's {len(leaves)} leaves, {n:,} parameters: the norm {float(scalars[0])!r} "
        f"against the plain version's {float(ref)!r}: {norm_r:.3f} of tolerance")
    if not norm_r <= 1.0:
        fail("B4's norm over phi4-mini's leaves disagrees with the plain version")
    fixed = scalars.clone()

    def update():
        b4.adamw_step(grads, mus, nus, params, fixed, lr, clip=True, **ADAMW_HYPER)

    def plain():
        out = norm_scale_ref(sumsq_ref(grads), 1.0)
        pstep = step.clone()
        bc1, bc2 = bias_corrections_ref(pstep, ADAMW_HYPER["b1"], ADAMW_HYPER["b2"])
        for g, m, v, p in zip(grads, mus, nus, params):
            adamw_step_ref(g, m, v, p, scale=out[1], lr=lr, bc1=bc1, bc2=bc2, **ADAMW_HYPER)

    before = b4.launches
    kern()
    per_call = b4.launches - before
    if per_call != 2 * len(leaves) + 1:
        fail(f"B4 launched {per_call} kernels over {len(leaves)} leaves, not {2 * len(leaves) + 1}")
    ms = {"sumsq and finish": graph_ms(norm, reps=2, iters=5),
          "update": graph_ms(update, reps=2, iters=5),
          "B4 (all three)": graph_ms(kern, reps=2, iters=5)}
    eager_ms = time_ms(kern, 3, warmup=1)
    plain_ms = graph_ms(plain, reps=1, iters=3)
    nbytes = sum(p.numel() * (4 * p.element_size() + 16) for p in params)
    bound_ms, bound_by = bound(19 * n, nbytes, "float32")
    say(f"  B4 in a CUDA graph: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
        + f" ({per_call} kernels a call: {len(leaves)} sums, the finish, {len(leaves)} "
        f"updates); launched from Python {eager_ms:.3f} ms; plain version (graph) "
        f"{plain_ms:.3f} ms; bound {bound_ms:.3f} ms ({bound_by}: {nbytes / 1e9:.3f} GB, "
        f"{nbytes / n:.2f} B a parameter), B4 at {bound_ms / ms['B4 (all three)']:.1%} of it")

    # the library: one fused AdamW call per dtype group, after the norms
    groups: dict = {}
    for i, p in enumerate(params):
        groups.setdefault(p.dtype, []).append(i)
    lib_note, lib_layout = "", "bf16 parameters and gradients, float32 moments (the port's)"
    lib_mus, lib_nus = mus, nus
    steps = [torch.zeros((), device="cuda") for _ in params]

    def library():
        torch._foreach_norm(grads)
        for idx in groups.values():
            torch._fused_adamw_([params[i] for i in idx], [grads[i] for i in idx],
                                [lib_mus[i] for i in idx], [lib_nus[i] for i in idx], [],
                                [steps[i] for i in idx], lr=ADAMW_LR, beta1=0.9, beta2=0.95,
                                weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False)

    try:
        library()
        torch.cuda.synchronize()
    except RuntimeError as err:
        lib_note = f"refused the port's layout ({str(err).splitlines()[0][:120]}); "
        lib_layout = (f"moments in the parameters' dtype (bf16 for "
                      f"{sum(p.dtype == torch.bfloat16 for p in params)} leaves)")
        del mus[:], nus[:]
        torch.cuda.empty_cache()
        lib_mus = [torch.zeros_like(p) for p in params]
        lib_nus = [torch.zeros_like(p) for p in params]
    # the gradient read twice (the norm, the update), the parameter and
    # both moments read and written once
    lib_bytes = sum(p.numel() * 4 * p.element_size() + m.numel() * 4 * m.element_size()
                    for p, m in zip(params, lib_mus))
    lib_ms = graph_ms(library, reps=1, iters=3)
    say(f"  library (torch._foreach_norm + torch._fused_adamw_ per dtype group, no clip, a "
        f"yardstick only): {lib_note}{lib_layout}: {lib_ms:.3f} ms in a CUDA graph, moving "
        f"{lib_bytes / 1e9:.3f} GB ({lib_bytes / 1e9 / 3.35:.3f} ms at 3.35 TB/s); "
        f"{nvidia_smi()}")
    del params, grads, mus, nus, lib_mus, lib_nus
    return dict(ms=ms["B4 (all three)"], sumsq_finish_ms=ms["sumsq and finish"],
                update_ms=ms["update"], eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, library_ms=lib_ms,
                library_layout=lib_layout, kernels_per_call=per_call,
                max_abs_err=max(ADAMW_ERR))


def train_adamw() -> dict:
    """19f: B4 against its plain version (:data:`ADAMW_CASES`), then timed
    over phi4-mini's leaves."""
    release()
    say(f"-- 19f: B4 (AdamW: sum of squares, finish, update) against its plain version, "
        f"{len(ADAMW_CASES)} cases x {ADAMW_STEPS} steps (moments rtol {ADAMW_MOMENT_RTOL} of "
        f"their terms, float32 p rtol {ADAMW_F32_PARAM_RTOL}, bf16 p 1 ulp, sums and norm rtol "
        f"{ADAMW_SUM_RTOL}, scale and bias corrections rtol {ADAMW_SCALAR_RTOL})")
    failed = adamw_check()
    if failed:
        fail(f"B4 disagrees with its plain version in {failed}")
    release()
    record = adamw_timing()
    release()
    return record


# 19g: B5 (cross-entropy on a vocabulary shard).  Each case is a batch x seq
# of token rows over one shard, the columns [start, start + width) of a
# vocabulary of vocab; offset puts the logits' base that many floats into
# their storage; neg_inf sets the shard's columns [4, 4 + neg_inf) to -inf
# (a thread's first groups all -inf).  (A NamedTuple: the tests load this
# file without registering it as a module, which a dataclass needs.)
class CeCase(NamedTuple):
    label: str
    batch: int
    seq: int
    width: int
    start: int
    vocab: int
    offset: int = 0
    neg_inf: int = 0

    @property
    def rows(self) -> int:
        return self.batch * self.seq


def ce_label_edges(case: CeCase) -> dict:
    """The labels every case puts on its first rows: -1 (masked), 0, the
    shard's last column, and a label outside the shard where the shard is
    not the whole vocabulary.  (:func:`_ce_inputs` also masks the last
    sequence whole.)"""
    edges = {"masked": -1, "zero": 0, "last": case.start + case.width - 1}
    if case.width < case.vocab:
        edges["outside"] = case.start + case.width if case.start == 0 else case.start - 1
    return edges


def ce_cases() -> list[CeCase]:
    """19g's cases: every shape the training paths give B5 (19c's and 21a's
    phi4-mini logits, 21d's xlstm-125m, 19d's smoke configs), one device's
    shard at phi4-mini's train_4k on 16x16 (the dry run's shape), a width
    off the 4-column group (scalar loads and a tail), the last of an uneven
    split, a base off 16 bytes, and -inf columns (the first four groups of
    threads 1-255 all -inf, so their running max stays -inf a while)."""
    import repro_torch.configs as C

    phi4, xlstm = C.get("phi4-mini-3.8b"), C.get("xlstm-125m")
    shard = phi4.padded_vocab // 16
    cases = [CeCase(f"19c phi4-mini {TRAIN_BATCH} x {TRAIN_SEQ} x {phi4.padded_vocab}",
                    TRAIN_BATCH, TRAIN_SEQ, phi4.padded_vocab, 0, phi4.padded_vocab),
             CeCase(f"phi4-mini train_4k on 16x16: 16 x 4096 x {shard} from column {5 * shard}",
                    16, 4096, shard, 5 * shard, phi4.padded_vocab),
             CeCase(f"21d xlstm-125m 2 x 512 x {xlstm.padded_vocab}", TRAIN_BATCH, TRAIN_SEQ,
                    xlstm.padded_vocab, 0, xlstm.padded_vocab)]
    for arch in SMOKE_TRAIN_ARCHS:
        v = C.get(arch, smoke=True).padded_vocab
        cases.append(CeCase(f"19d {arch} smoke {TRAIN_BATCH} x 64 x {v}", TRAIN_BATCH, 64, v, 0, v))
    return cases + [CeCase("width 1003, off the 4-column group", 3, 11, 1003, 0, 1003),
                    CeCase("the last of an uneven split: 4001 columns from 8000", 2, 8, 4001,
                           8000, 12001),
                    CeCase("base off 16 bytes, 2048 columns", 2, 16, 2048, 0, 2048, offset=1),
                    CeCase("-inf in columns 4-4099 of 8192", 2, 16, 8192, 0, 8192,
                           neg_inf=4096)]


# Tolerances of 19g, from the kernel's arithmetic against the plain
# version's on the card (u = 2**-24, a float32 half-ulp):
# * m and the label's logit: equal (a max and a copy round nothing);
# * s: each term exp(x - m) is within 2 ulps (CUDA's expf) on either side,
#   and each add, each rescale of a thread's sum by a new max and each merge
#   of the block's tree rounds once: relative to s, at most u times twice
#   the adds on a thread's chain (4 a group it takes, its tail) plus 64 for
#   the expf, the rescales and the tree (:func:`ce_sum_rtol`);
# * each token's nll = lse - gold: s's relative error (log turns it into an
#   absolute one) plus 4u x (|lse| + |gold|) for the log, the add and the
#   subtraction;
# * dlogits: g·(exp(x - lse) - onehot) on the same lse and g, each element
#   held to its own size.  Each side's exp is within 2 ulps (4u) of the
#   true value and the subtraction and the product round once each, so off
#   the label's column |d - plain| <= 10u·|plain|; at the label's column
#   exp's error is carried by e - 1 as an absolute 8u·|g| at most, plus
#   4u·|plain|.  Held: CE_GRAD_RTOL·(|plain| + |g|·onehot).  A kernel that
#   writes 0 (or anything off by more than 16u) for the small exp(x - lse)
#   of most columns fails; a masked token (g = 0) must be exactly 0.
CE_U = 2.0 ** -24
CE_GRAD_RTOL = 16 * CE_U
# the largest |dlogits - plain| of each ce_check run (the kernels line)
CE_ERR: list = []


def ce_sum_rtol(width: int) -> float:
    """s's relative tolerance at ``width`` columns (the comment above):
    a thread's chain is 4 adds for each of its groups of 4 columns (at most
    ``ceil(groups / THREADS)``), and thread 0's also the ``width % 4``
    tail."""
    from repro_torch.kernels.cross_entropy.kernel import THREADS

    groups, tail = divmod(width, 4)
    chain = 4 * -(-groups // THREADS) + tail
    return CE_U * (2 * chain + 64)


def _ce_inputs(case: CeCase, seed: int):
    """Logits N(0, 4) (a trained model's logits spread about as far), the
    case's -inf columns, and labels: a quarter of the rows on the shard's
    columns, the rest anywhere in the vocabulary (none on a -inf column),
    then :func:`ce_label_edges` on the first rows and the last sequence
    masked."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    store = torch.empty(case.rows * case.width + case.offset, device="cuda")
    x = store[case.offset:].view(case.rows, case.width)
    x.normal_(0.0, 4.0, generator=gen)
    lab = torch.randint(0, case.vocab, (case.rows,), generator=gen, device="cuda")
    inside = torch.randint(case.start, case.start + case.width, (case.rows,), generator=gen,
                           device="cuda")
    lab[::4] = inside[::4]
    if case.neg_inf:
        x[:, 4:4 + case.neg_inf] = float("-inf")
        col = lab - case.start
        lab[(col >= 4) & (col < 4 + case.neg_inf)] = case.start
    edges = list(ce_label_edges(case).values())
    lab[:len(edges)] = torch.tensor(edges, device="cuda")
    lab[-case.seq:] = -1                    # a fully masked sequence
    return x, lab


def ce_check(cases=None) -> list[str]:
    """19g's check: each case through B5 (``ce_partials``, ``ce_backward``)
    and through the plain versions on the same inputs, the backward on the
    plain ``lse`` and the train step's ``g`` (mask / count).  Prints each
    case's share of every tolerance; returns the labels of the cases that
    failed."""
    import torch

    from repro_torch.kernels.cross_entropy import kernel as b5
    from repro_torch.kernels.cross_entropy.ops import combine
    from repro_torch.kernels.cross_entropy.ref import ce_backward_ref, ce_partials_ref

    failed, worst_abs = [], 0.0
    for c, case in enumerate(cases or ce_cases()):
        x, lab = _ce_inputs(case, 300 + c)
        m, s, gold = b5.ce_partials(x, lab, case.start, case.vocab)
        pm, ps, pg = ce_partials_ref(x, lab, case.start, case.vocab)
        same = bool(torch.equal(m, pm)) and bool(torch.equal(gold, pg))
        s_r = ((s - ps).abs() / (ps * ce_sum_rtol(case.width))).max().item()
        lse, nll_gold = combine(m, s, gold)
        plse, pgold = combine(pm, ps, pg)
        nll_tol = ce_sum_rtol(case.width) + 4 * CE_U * (plse.abs() + pgold.abs())
        nll_r = (((lse - nll_gold) - (plse - pgold)).abs() / nll_tol).max().item()
        mask = (lab >= 0).float()
        g = mask / mask.sum().clamp(min=1.0)
        d = b5.ce_backward(x, lab, case.start, plse, g, case.vocab)
        pd = ce_backward_ref(x, lab, case.start, plse, g)
        diff = (d - pd).abs_()
        worst_abs = max(worst_abs, diff.max().item())
        unequal = int((diff > 0).sum().item())
        tol = pd.abs().mul_(CE_GRAD_RTOL)
        col = lab.clamp(min=0) - case.start
        hit = ((col >= 0) & (col < case.width)).nonzero()[:, 0]
        tol[hit, col[hit]] += CE_GRAD_RTOL * g.abs()[hit]
        # an element held to 0 (g = 0, or exp(x - lse) = 0) must be 0; a NaN
        # stays NaN and fails
        share = (diff / tol).masked_fill_((tol == 0) & (diff == 0), 0.0)
        d_r = share.max().item()
        del tol, share
        masked_zero = not bool(d[lab < 0].any())
        torch.cuda.synchronize()
        ok = same and all(r <= 1.0 for r in (s_r, nll_r, d_r)) and masked_zero
        say(f"  {case.label}: {case.rows} rows x {case.width} (base +{case.offset}; labels "
            f"{','.join(ce_label_edges(case))},masked row; -inf columns {case.neg_inf}): m and "
            f"the label's logit bit-equal {same}; of tolerance s {s_r:.3f} (rtol "
            f"{ce_sum_rtol(case.width):.2e}), nll {nll_r:.3f}, dlogits {d_r:.3f} (rtol "
            f"{CE_GRAD_RTOL:.2e} of each |plain|, + |g| at the label); dlogits not bit-equal "
            f"{unequal} of {d.numel()}; masked tokens' gradient 0: {masked_zero}"
            f"{'' if ok else '  <-- FAILS'}")
        if not ok:
            failed.append(case.label)
        del x, lab, d, pd, diff, m, s, gold, pm, ps, pg
    CE_ERR.append(worst_abs)
    say(f"  largest |dlogits - plain| over the cases: {worst_abs:.3e}")
    return failed


def ce_timing(case: CeCase) -> dict:
    """B5 at ``case``'s shape in a CUDA graph, forward and backward apart and
    together, and from Python, beside the plain versions, the bound and the
    library (``F.cross_entropy(..., reduction="none")`` forward and backward
    on the same logits, every label on the shard's columns; a yardstick
    only)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.cross_entropy import kernel as b5
    from repro_torch.kernels.cross_entropy.ops import combine
    from repro_torch.kernels.cross_entropy.ref import ce_backward_ref, ce_partials_ref

    x, lab = _ce_inputs(case, 400)
    R, V = case.rows, case.width
    mask = (lab >= 0).float()
    g = mask / mask.sum()
    lse = combine(*ce_partials_ref(x, lab, case.start, case.vocab))[0]
    out = {}

    def fwd():
        out["f"] = b5.ce_partials(x, lab, case.start, case.vocab)

    def bwd():
        out["b"] = b5.ce_backward(x, lab, case.start, lse, g, case.vocab)

    def both():
        fwd()
        bwd()

    def plain():
        out["p"] = ce_partials_ref(x, lab, case.start, case.vocab)
        out["pb"] = ce_backward_ref(x, lab, case.start, lse, g)

    before = b5.launches
    both()
    if b5.launches - before != 2:
        fail(f"B5 launched {b5.launches - before} kernels for a forward and a backward, not 2")
    ms = {"forward": graph_ms(fwd), "backward": graph_ms(bwd), "both": graph_ms(both)}
    eager_ms = time_ms(both, 20)
    plain_ms = graph_ms(plain, reps=2, iters=10)
    fwd_bytes, bwd_bytes = 4 * R * V + 8 * R + 12 * R, 8 * R * V + 8 * R + 8 * R
    bound_f = bound(4 * R * V, fwd_bytes, "float32")
    bound_b = bound(4 * R * V, bwd_bytes, "float32")
    bound_ms, bound_by = bound(8 * R * V, fwd_bytes + bwd_bytes, "float32")
    # the library takes a label on the shard's columns: every label at or
    # above 0 is moved onto them (the same reads and writes; other values)
    xr = x.detach().requires_grad_()
    y = (lab.clamp(min=0) - case.start).remainder_(V)
    lib_note = "in a CUDA graph"

    def library():
        out["l"] = torch.autograd.grad(F.cross_entropy(xr, y, reduction="none"), xr, g)

    try:
        lib_ms = graph_ms(library, reps=5, iters=10)
    except RuntimeError as err:
        lib_note = f"from Python (the graph refused it: {str(err).splitlines()[0][:100]})"
        lib_ms = time_ms(library, 10)
    say(f"  {case.label}: B5 in a CUDA graph: forward {ms['forward']:.5f} ms (bound "
        f"{bound_f[0]:.5f}, {bound_f[0] / ms['forward']:.1%} of it), backward "
        f"{ms['backward']:.5f} ms (bound {bound_b[0]:.5f}, {bound_b[0] / ms['backward']:.1%}), "
        f"both {ms['both']:.5f} ms (bound {bound_ms:.5f}, {bound_by}: "
        f"{(fwd_bytes + bwd_bytes) / 1e9:.3f} GB); from Python {eager_ms:.5f} ms; plain "
        f"version {plain_ms:.5f} ms; F.cross_entropy forward + backward {lib_ms:.5f} ms "
        f"{lib_note}; {nvidia_smi()}")
    del x, lab, out, xr
    return dict(ms=ms["both"], forward_ms=ms["forward"], backward_ms=ms["backward"],
                eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                forward_bound_ms=bound_f[0], backward_bound_ms=bound_b[0],
                bytes=fwd_bytes + bwd_bytes, library_ms=lib_ms, shape=[R, V])


def train_ce() -> dict:
    """19g: B5 against its plain version (:func:`ce_cases`), then timed at
    19c's logits, at the train_4k shard and at xlstm-125m's."""
    release()
    cases = ce_cases()
    say(f"-- 19g: B5 (cross-entropy on a vocabulary shard: partials, backward) against its "
        f"plain version, {len(cases)} cases (m and the label's logit bit-equal, s rtol "
        f"ce_sum_rtol(width), dlogits {CE_GRAD_RTOL:.2e} x (|plain| + |g| at the label))")
    failed = ce_check(cases)
    if failed:
        fail(f"B5 disagrees with its plain version in {failed}")
    release()
    record = ce_timing(cases[0])
    for case in cases[1:3]:
        release()
        other = ce_timing(case)
        record[f"ms at {other['shape']}"] = other["ms"]
        record[f"bound_ms at {other['shape']}"] = other["bound_ms"]
    release()
    record["max_abs_err"] = max(CE_ERR)
    return record


# substrings of the names of cuBLAS's matrix-product kernels (on Hopper,
# CUDA 12's cuBLAS names most of them nvjet_*)
GEMM_NAMES = ("nvjet", "gemm", "xmma", "cutlass", "cublas")
# B4's three kernels, by a substring of their names
B4_KERNELS = ("adamw_sumsq", "adamw_finish", "adamw_step")
# B4 in the profiled training replays: replays read, the B4 kernels the
# profiler saw in them, and the kernels the wrapper counted when the step
# was captured (the kernels line's kernels_per_launch is their ratio)
B4_REPLAYS = {"replays": 0, "kernels": 0, "calls": 0}
# B5's two kernels, and B5 and B1's backward in the profiled training
# replays, counted as B4's are (B1's backward: its three kernels over the
# wrapper's calls in the capture)
B5_KERNELS = ("ce_partials_kernel", "ce_backward_kernel")
B5_REPLAYS = {"replays": 0, "kernels": 0, "calls": 0}
B1BWD_REPLAYS = {"replays": 0, "kernels": 0, "calls": 0}


def kernels_in_replay(run, attempts: int = 4) -> list:
    """The device kernels of one call of ``run``, a training replay: it
    moves the state, so its outputs differ from call to call.  The outputs
    of the call before are poisoned before each profiled call, which must
    give finite outputs again; a reading is taken once two sessions in a
    row record the same kernels and no earlier one recorded more (up to
    ``attempts``; else the fullest)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile
    from torch.utils import _pytree as pytree

    readings = []
    last = run()
    torch.cuda.synchronize()
    for _ in range(attempts):
        _poison(last)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            spin()
            last = run()
            torch.cuda.synchronize()
        if not all(bool(torch.isfinite(t).all()) for t in pytree.tree_leaves(last)
                   if isinstance(t, torch.Tensor)):
            fail("a profiled training replay left its poisoned outputs: it ran nothing")
        events = device_events(prof)
        counts = collections.Counter(e.name for e in events)
        if (events and readings and readings[-1][0] == counts
                and all(len(ev) <= len(events) for _, ev in readings)):
            return events
        if readings:
            say(f"    (two profiler sessions of a replay recorded {len(readings[-1][1])} and "
                f"{len(events)} device events: profiling again)")
        readings.append((counts, events))
    return max((ev for _, ev in readings), key=len)


def _b1_kernels(events) -> dict:
    """B1's forward and backward kernels among ``events``, by kind."""
    kinds = {"flash_fwd": 0, "bwd_dot": 0, "bwd_dkdv": 0, "bwd_dq": 0}
    for e in events:
        for kind in kinds:
            if kind in e.name:
                kinds[kind] += 1
    return kinds


def train_phi4() -> dict:
    """19c: phi4-mini-3.8b at full width and depth, bf16, AdamW with the
    cosine schedule, data from the port's ``SyntheticLM``: eager steps
    against as many replays of the sealed step from the same state, then
    replays to ``TRAIN_REPLAYS`` (the loss must fall), the kernels of one
    replay, and a checkpoint restored into a fresh model giving the same
    loss."""
    import gc
    import shutil

    import numpy as np
    import torch

    import repro_torch.configs as C
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.data import SyntheticLM, data_config_for
    from repro_torch.kernels.adamw import kernel as b4
    from repro_torch.kernels.cross_entropy import kernel as b5
    from repro_torch.kernels.flash_attention import backward, kernel
    from repro_torch.launch import serve
    from repro_torch.models import Transformer
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.training import make_train_step, seal_train_step
    from repro_torch.training.train_lib import batch_to_device

    release()
    cfg = dataclasses.replace(C.get("phi4-mini-3.8b"), dtype="bfloat16")
    data = SyntheticLM(data_config_for(cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ))
    batches = [data.batch(i) for i in range(TRAIN_REPLAYS + 1)]
    leaves = len(phi4_leaves())
    b4_step = 2 * leaves + 1        # B4's kernels a step: the sums, the finish, the updates
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def lr(step):
        return cosine_schedule(step, peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                               total_steps=TRAIN_REPLAYS)

    def fresh():
        model = serve.init_params(cfg, seed=0, device="cuda")
        return model, adamw_init(dict(model.named_parameters()))

    step_fn = make_train_step(cfg, lr=lr)
    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()          # the earlier phases' leftovers
    model, state = fresh()
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    say(f"-- 19c: {cfg.name} full width, {cfg.n_layers} layers, bf16, {n / 1e9:.3f} B "
        f"parameters, AdamW (float32 moments) with the cosine schedule (peak {TRAIN_LR}, "
        f"warm-up {TRAIN_WARMUP}), batch {TRAIN_BATCH} x {TRAIN_SEQ} from SyntheticLM; "
        f"initialised in {time.perf_counter() - t0:.1f}s")

    # eager steps (run-time scheduled: PyTorch's own loop)
    # the path's run starts here
    kernel.launches = backward.launches = b4.launches = b5.launches = 0
    copies, b4_copies = kernel.layout_copies, b4.layout_copies
    b5_copies = b5.layout_copies
    eager_loss, eager_gnorm, eager_ms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_EAGER):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i:
            m = step_fn(model, state, batch_to_device(batches[i], "cuda"))[2]
        else:       # the first step, left out of the eager ms, by chain under the profiler
            m, chains = chain_breakdown(
                lambda: step_fn(model, state, batch_to_device(batches[0], "cuda"))[2],
                "19c, the first eager step", chain_bytes(cfg, tokens))
        eager_loss.append(float(m["loss"]))
        eager_ms.append((time.perf_counter() - t) * 1e3)
        eager_gnorm.append(float(m["grad_norm"]))
        del m
    eager_peak = torch.cuda.max_memory_allocated()
    eager_params = [p.detach().cpu() for p in model.parameters()]
    eager_counts = (kernel.launches, backward.launches)
    eager_b4, eager_b5 = b4.launches, b5.launches
    say(f"  eager steps: loss {eager_loss}, ms {[round(x, 3) for x in eager_ms]}, peak "
        f"memory {eager_peak / 2**30:.2f} GiB; B1 forward launches {eager_counts[0]}, "
        f"backward launches {eager_counts[1]}; B4 kernels {eager_b4} ({TRAIN_EAGER} x "
        f"{b4_step}: {leaves} sums, the finish, {leaves} updates a step); B5 kernels "
        f"{eager_b5} ({TRAIN_EAGER} x 2: the loss's partials and its backward)")
    if eager_counts != (TRAIN_EAGER * cfg.n_layers,) * 2:
        fail(f"eager steps launched B1 {eager_counts} times, not {TRAIN_EAGER} x "
             f"{cfg.n_layers} forward and backward")
    if eager_b4 != TRAIN_EAGER * b4_step:
        fail(f"eager steps launched {eager_b4} B4 kernels, not {TRAIN_EAGER} x {b4_step}")
    if eager_b5 != TRAIN_EAGER * 2:
        fail(f"eager steps launched {eager_b5} B5 kernels, not {TRAIN_EAGER} x 2")
    del model, state
    gc.collect()
    torch.cuda.empty_cache()

    # the same steps sealed as one CUDA graph, from the same state
    model, state = fresh()
    torch.cuda.reset_peak_memory_stats()
    # the seal's warm-up runs loss and grads once before the capture: its
    # launches of B1's backward and B5 are counted apart from the capture's
    warm = {}

    def counted(*args):
        start = (backward.launches, b5.launches)
        out = inner(*args)
        warm["bwd"], warm["b5"] = backward.launches - start[0], b5.launches - start[1]
        return out

    captured: dict = {}
    with capture_counts(step_fn, captured):
        inner = step_fn.loss_and_grads        # counted calls it: capture_counts' warm-up count
        step_fn.loss_and_grads = counted
        sealed = seal_train_step(step_fn, model, state, batches[0])
        step_fn.loss_and_grads = inner
    seal_peak, seal_s = torch.cuda.max_memory_allocated(), sealed.seal_s
    say(f"  sealed fwd + bwd + clip + AdamW as one CUDA graph in {seal_s:.2f}s (warm-up "
        f"of loss and grads, empty_cache, capture); peak memory {seal_peak / 2**30:.2f} GiB, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated after")
    seal_counts = (kernel.launches - eager_counts[0], backward.launches - eager_counts[1])
    seal_b4, seal_b5 = b4.launches - eager_b4, b5.launches - eager_b5
    capture_bwd, capture_b5 = seal_counts[1] - warm["bwd"], seal_b5 - warm["b5"]
    copies, b4_copies = kernel.layout_copies - copies, b4.layout_copies - b4_copies
    b5_copies = b5.layout_copies - b5_copies
    say(f"  layout copies by B1's forward and backward over the eager steps and the seal: "
        f"{copies}; gradients B4 copied to be contiguous: {b4_copies}; inputs B5 copied: "
        f"{b5_copies}; B4 kernels by the seal {seal_b4} (the capture's: {leaves} sums, the "
        f"finish, {leaves} updates); B1 backward calls by the seal {seal_counts[1]} (warm-up "
        f"{warm['bwd']}, capture {capture_bwd}); B5 kernels by the seal {seal_b5} (warm-up "
        f"{warm['b5']}, capture {capture_b5})")
    if copies:
        fail(f"the training path copied {copies} inputs of B1 that the kernels should read in place")
    if seal_b4 != b4_step:
        fail(f"the seal launched {seal_b4} B4 kernels, not {b4_step}")
    if b5_copies or warm["b5"] != 2 or capture_b5 != 2:
        fail(f"the seal launched B5 {warm['b5']} times in its warm-up and {capture_b5} in the "
             f"capture (want 2 and 2), with {b5_copies} layout copies")
    losses, replay_ms, gnorms = [], [], []
    for i in range(TRAIN_REPLAYS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = sealed(batches[i])
        losses.append(float(m["loss"]))
        replay_ms.append((time.perf_counter() - t) * 1e3)
        gnorms.append(float(m["grad_norm"]))
        if i == TRAIN_EAGER - 1:
            # phase 21 holds the sharded step against these
            replay_params = [p.detach().cpu() for p in model.parameters()]
            diffs, same = 0.0, 0
            for p, e in zip(model.parameters(), eager_params):
                e = e.cuda()
                diffs = max(diffs, (p.detach().float() - e.float()).abs().max().item())
                same += int((p.detach() == e).sum())
                del e
            say(f"  {TRAIN_EAGER} replays against the {TRAIN_EAGER} eager steps: losses "
                f"{losses} vs {eager_loss}; parameters: {same / n:.6%} bit-identical, max "
                f"|diff| {diffs:.3e}")
            loss_r = max(abs(a - b) / abs(b) for a, b in zip(losses, eager_loss))
            if not (loss_r <= 2e-3 and diffs <= 2 * TRAIN_LR * TRAIN_EAGER):
                fail(f"replays differ from eager steps: losses {loss_r:.3e} relative (limit "
                     f"2e-3), parameters {diffs:.3e} (limit {2 * TRAIN_LR * TRAIN_EAGER:.1e}, "
                     f"{TRAIN_EAGER} Adam steps of at most lr apart)")
            del eager_params
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    steady = replay_ms[TRAIN_EAGER:]
    replay_med, eager_med = float(np.median(steady)), float(np.median(eager_ms[1:]))
    say(f"  {TRAIN_REPLAYS} replays: loss {losses[0]:.4f} -> {losses[-1]:.4f} (first 5 mean "
        f"{first:.4f}, last 5 mean {last:.4f}); all finite: "
        f"{all(math.isfinite(x) for x in losses)}")
    if not (all(math.isfinite(x) for x in losses) and last < first):
        fail("the sealed step's loss did not fall over the replays")
    say(f"  Fig. 8's quantity (host clock, batch copied in, synchronised per step): eager "
        f"{eager_med:.3f} ms/step ({tokens / eager_med * 1e3:,.0f} tok/s), sealed replay "
        f"{replay_med:.3f} ms/step ({tokens / replay_med * 1e3:,.0f} tok/s): "
        f"{eager_med / replay_med:.3f}x")
    dev_ms = time_ms(sealed.graph.replay, 5, warmup=1)
    say(f"  one replay on CUDA events (no batch copy): {dev_ms:.3f} ms")

    events = kernels_in_replay(lambda: sealed())
    kinds = _b1_kernels(events)
    b4_kinds = {kind: sum(1 for e in events if kind in e.name) for kind in B4_KERNELS}
    b5_kinds = {kind: sum(1 for e in events if kind in e.name) for kind in B5_KERNELS}
    rows = sorted(by_kernel(events), reverse=True)
    total = sum(us for us, _, _ in rows)
    b1 = {kind: sum(us for us, _, key in rows if kind in key) for kind in kinds}
    b4_us = {kind: sum(us for us, _, key in rows if kind in key) for kind in B4_KERNELS}
    b5_us = {kind: sum(us for us, _, key in rows if kind in key) for kind in B5_KERNELS}
    gemm = sum(us for us, _, key in rows if any(w in key.lower() for w in GEMM_NAMES))
    rest = total - gemm - sum(b1.values()) - sum(b4_us.values()) - sum(b5_us.values())
    say(f"  one profiled replay: {sum(c for _, c, _ in rows)} device kernels, "
        f"{total / 1e3:.3f} ms of kernel time: B4 {sum(b4_us.values()) / 1e3:.3f} ms "
        f"({sum(b4_us.values()) / total:.1%}: "
        + ", ".join(f"{k} x{b4_kinds[k]} {v / 1e3:.3f} ms" for k, v in b4_us.items())
        + f"), cuBLAS products {gemm / 1e3:.3f} ms ({gemm / total:.1%}), B1 "
        f"{sum(b1.values()) / 1e3:.3f} ms ({sum(b1.values()) / total:.1%}), B5 (the loss) "
        f"{sum(b5_us.values()) / 1e3:.3f} ms ("
        + ", ".join(f"{k} x{b5_kinds[k]} {v / 1e3:.3f} ms" for k, v in b5_us.items())
        + f"), the rest (element-wise: casts, norms, activations, the gradients' sums) "
        f"{rest / 1e3:.3f} ms ({rest / total:.1%}); B1 {kinds} ("
        + ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in b1.items()) + "); top:")
    for us, count, key in rows[:6]:
        say(f"      {us / 1e3:9.3f} ms x{count:4d}  {key[:90]}")
    if kinds != {kind: cfg.n_layers for kind in kinds}:
        fail(f"a replay ran B1's kernels {kinds}, not {cfg.n_layers} of each")
    want_b4 = {"adamw_sumsq": leaves, "adamw_finish": 1, "adamw_step": leaves}
    B4_REPLAYS["replays"] += 1
    B4_REPLAYS["kernels"] += sum(b4_kinds.values())
    B4_REPLAYS["calls"] += seal_b4
    say(f"  B4 in the profiled replay: {sum(b4_kinds.values())} kernels for the {seal_b4} the "
        f"wrapper counted in the capture")
    if b4_kinds != want_b4:
        fail(f"a replay ran B4's kernels {b4_kinds}, not {want_b4}")
    B5_REPLAYS["replays"] += 1
    B5_REPLAYS["kernels"] += sum(b5_kinds.values())
    B5_REPLAYS["calls"] += capture_b5
    bwd_kernels = sum(kinds[k] for k in BWD_KERNELS)
    B1BWD_REPLAYS["replays"] += 1
    B1BWD_REPLAYS["kernels"] += bwd_kernels
    B1BWD_REPLAYS["calls"] += capture_bwd
    say(f"  B5 in the profiled replay: {sum(b5_kinds.values())} kernels for the {capture_b5} "
        f"the wrapper counted in the capture; B1's backward: {bwd_kernels} kernels for the "
        f"{capture_bwd} calls it counted there")
    if b5_kinds != {kind: 1 for kind in B5_KERNELS}:
        fail(f"a replay ran B5's kernels {b5_kinds}, not one of each")
    check_norm_rope(rows, cfg, "training replay", backward=True, again=lambda: sealed(),
                    captured=captured)

    # checkpoint: the parameters now, one replay, then the same parameters
    # restored into a fresh model and copied into the graph's: same loss
    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    t = time.perf_counter()
    save_checkpoint(ckpt, {"params": model}, step=TRAIN_REPLAYS)
    save_s = time.perf_counter() - t
    loss_a = float(sealed(batches[-1])["loss"])
    t = time.perf_counter()
    restored = Transformer(cfg, device="cpu")
    _, manifest = restore_checkpoint(ckpt, {"params": restored})
    load_s = time.perf_counter() - t
    with torch.no_grad():
        for p, r in zip(model.parameters(), restored.parameters()):
            p.copy_(r)
    loss_b = float(sealed(batches[-1])["loss"])
    size = sum(f.stat().st_size for f in ckpt.iterdir())
    shutil.rmtree(ckpt, ignore_errors=True)
    say(f"  checkpoint of {size / 2**30:.2f} GiB saved in {save_s:.1f}s, restored into a "
        f"fresh model in {load_s:.1f}s (step {manifest['step']}); the next replay's loss "
        f"{loss_a!r} before, {loss_b!r} from the restored parameters")
    if loss_a != loss_b:
        fail("the restored checkpoint gives another loss")
    del restored, sealed, model, state
    reference = dict(eager_loss=eager_loss, eager_gnorm=eager_gnorm,
                     replay_loss=losses[:TRAIN_EAGER], replay_gnorm=gnorms[:TRAIN_EAGER],
                     params=replay_params, eager_counts=eager_counts, seal_counts=seal_counts,
                     eager_ms=eager_med, replay_ms=replay_med, replay_device_ms=dev_ms,
                     eager_peak=eager_peak, base=base, eager_b4=eager_b4, seal_b4=seal_b4,
                     eager_b5=eager_b5, seal_b5=seal_b5)
    return dict(eager_ms=eager_med, replay_ms=replay_med, replay_device_ms=dev_ms,
                reference=reference,
                tokens_per_step=tokens, seal_s=seal_s, seal_peak_gib=seal_peak / 2**30,
                eager_peak_gib=eager_peak / 2**30, losses=losses,
                fwd_launches=kernel.launches, bwd_launches=backward.launches,
                seal_launches=seal_counts, in_replay=kinds, b1_replay_ms=b1,
                layout_copies=copies, b4_in_replay=b4_kinds, b4_replay_ms=b4_us,
                b5_in_replay=b5_kinds, b5_replay_ms=b5_us,
                replay_kernel_ms=total / 1e3, replay_kernels=sum(c for _, c, _ in rows),
                tokens_per_s=tokens / replay_med * 1e3, chains=chains)


# 19h: deepseek-v2-236b at full width cut to TRAIN_MLA_LAYERS of its 60
# layers, bf16, batch TRAIN_MLA_BATCH x TRAIN_MLA_SEQ (train_4k's sequence
# length) from SyntheticLM: TRAIN_EAGER eager steps against as many replays
# of the sealed step from the same state, then replays to TRAIN_MLA_REPLAYS
TRAIN_MLA_LAYERS, TRAIN_MLA_BATCH, TRAIN_MLA_SEQ = 1, 2, 4096
TRAIN_MLA_REPLAYS = 20
# B7's kernels in a replay: the forward, then the backward's pre-pass, dK/dV,
# dQ and the rope reduce (csrc); B2's expert GEMMs
B7_KERNELS = ("exp_fwd_bf16", "exp_bwd_prep", "exp_dkdv_bf16", "exp_dq_bf16", "exp_rope_reduce")
B7_REPLAYS = {"replays": 0, "kernels": 0, "calls": 0}


def train_deepseek() -> dict:
    """19h: deepseek-v2-236b at full width (d 5120, 128 heads, q_lora 1536,
    kv_lora 512, 160 experts top-6) cut to ``TRAIN_MLA_LAYERS`` layer, bf16,
    AdamW on B4, the loss on B5, the expert GEMMs and their backward on B2,
    MLA's expanded form on B7 forward and backward: eager steps against
    replays of the sealed step from the same state (losses and grad norms
    bit for bit), then replays over which the loss must fall, and the
    kernels of one profiled replay."""
    import gc

    import numpy as np
    import torch

    import repro_torch.configs as C
    from repro_torch.data import SyntheticLM, data_config_for
    from repro_torch.kernels.adamw import kernel as b4
    from repro_torch.kernels.cross_entropy import kernel as b5
    from repro_torch.kernels.expanded_attention import backward as b7_bwd
    from repro_torch.kernels.expanded_attention import kernel as b7
    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.launch import serve
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.training import make_train_step, seal_train_step
    from repro_torch.training.train_lib import batch_to_device

    release()
    cfg = dataclasses.replace(C.get("deepseek-v2-236b"), n_layers=TRAIN_MLA_LAYERS,
                              dtype="bfloat16")
    data = SyntheticLM(data_config_for(cfg, batch_size=TRAIN_MLA_BATCH, seq_len=TRAIN_MLA_SEQ))
    batches = [data.batch(i) for i in range(TRAIN_MLA_REPLAYS)]
    tokens = TRAIN_MLA_BATCH * TRAIN_MLA_SEQ

    def lr(step):
        return cosine_schedule(step, peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                               total_steps=TRAIN_MLA_REPLAYS)

    def fresh():
        model = serve.init_params(cfg, seed=0, device="cuda")
        return model, adamw_init(dict(model.named_parameters()))

    def counts():
        return (b7.launches, b7_bwd.launches, pack.launches, b4.launches, b5.launches)

    step_fn = make_train_step(cfg, lr=lr)
    t0 = time.perf_counter()
    model, state = fresh()
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    leaves = len(list(model.parameters()))
    say(f"-- 19h: {cfg.name} full width (d {cfg.d_model}, {cfg.n_heads} heads, q_lora "
        f"{cfg.mla.q_lora_rank}, kv_lora {cfg.mla.kv_lora_rank}, {cfg.moe.num_experts} experts "
        f"top-{cfg.moe.top_k}), {cfg.n_layers} of its 60 layers, bf16, {n / 1e9:.3f} B "
        f"parameters, AdamW (float32 moments), batch {TRAIN_MLA_BATCH} x {TRAIN_MLA_SEQ} from "
        f"SyntheticLM; initialised in {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    # eager steps; the path's run starts here
    b7.launches = b7_bwd.launches = pack.launches = b4.launches = b5.launches = 0
    copies, pack_copies = b7.layout_copies, pack.layout_copies
    eager_loss, eager_gnorm, eager_ms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_EAGER):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i:
            m = step_fn(model, state, batch_to_device(batches[i], "cuda"))[2]
        else:       # the first step, left out of the eager ms, by chain under the profiler
            m, chains = chain_breakdown(
                lambda: step_fn(model, state, batch_to_device(batches[0], "cuda"))[2],
                "19h, the first eager step", chain_bytes(cfg, tokens))
        eager_loss.append(float(m["loss"]))
        eager_ms.append((time.perf_counter() - t) * 1e3)
        eager_gnorm.append(float(m["grad_norm"]))
        del m
    eager_peak = torch.cuda.max_memory_allocated()
    eager_params = [p.detach().cpu() for p in model.parameters()]
    eager = counts()
    say(f"  eager steps: loss {eager_loss}, grad norm {eager_gnorm}, ms "
        f"{[round(x, 3) for x in eager_ms]}, peak memory {eager_peak / 2**30:.2f} GiB; B7 "
        f"forward calls {eager[0]}, backward calls {eager[1]}; B2 calls {eager[2]}; B4 kernels "
        f"{eager[3]}; B5 kernels {eager[4]}")
    want = (TRAIN_EAGER * cfg.n_layers, TRAIN_EAGER * cfg.n_layers)
    if eager[:2] != want or min(eager[2:]) == 0:
        fail(f"the eager steps launched B7 {eager[:2]} times (want {want}), B2, B4, B5 "
             f"{eager[2:]}")
    del model, state
    gc.collect()
    torch.cuda.empty_cache()

    # the same steps sealed as one CUDA graph, from the same state
    model, state = fresh()
    torch.cuda.reset_peak_memory_stats()
    captured: dict = {}
    with capture_counts(step_fn, captured):
        sealed = seal_train_step(step_fn, model, state, batches[0])
    seal_peak, seal_s = torch.cuda.max_memory_allocated(), sealed.seal_s
    seal = tuple(c1 - c0 for c1, c0 in zip(counts(), eager))
    layout = (b7.layout_copies - copies, pack.layout_copies - pack_copies)
    say(f"  sealed fwd + bwd + clip + AdamW as one CUDA graph in {seal_s:.2f}s; peak memory "
        f"{seal_peak / 2**30:.2f} GiB, {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"after; B7 forward and backward calls by the seal (warm-up and capture) {seal[:2]}; "
        f"layout copies by B7 and B2 over the eager steps and the seal: {layout}")
    if seal[:2] != (2 * cfg.n_layers, 2 * cfg.n_layers) or any(layout):
        fail(f"the seal launched B7 {seal[:2]} times (want twice {cfg.n_layers} each) or made "
             f"layout copies {layout}")
    losses, gnorms, replay_ms = [], [], []
    for i in range(TRAIN_MLA_REPLAYS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = sealed(batches[i])
        losses.append(float(m["loss"]))
        replay_ms.append((time.perf_counter() - t) * 1e3)
        gnorms.append(float(m["grad_norm"]))
        if i == TRAIN_EAGER - 1:
            same, total = 0, 0
            for p, e in zip(model.parameters(), eager_params):
                same += int((p.detach().cpu() == e).sum())
                total += e.numel()
            say(f"  {TRAIN_EAGER} replays against the {TRAIN_EAGER} eager steps: losses "
                f"{losses} vs {eager_loss}, grad norms {gnorms} vs {eager_gnorm}; parameters "
                f"{same / total:.6%} bit-identical")
            if losses != eager_loss or gnorms != eager_gnorm or same != total:
                fail("the sealed step's replays are not bit-identical to the eager steps")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    say(f"  {TRAIN_MLA_REPLAYS} replays: loss {losses[0]:.4f} -> {losses[-1]:.4f} (first 5 mean "
        f"{first:.4f}, last 5 mean {last:.4f})")
    if not (all(math.isfinite(x) for x in losses) and last < first):
        fail("19h's loss did not fall over the replays")
    replay_med = float(np.median(replay_ms[TRAIN_EAGER:]))
    eager_med = float(np.median(eager_ms[1:]))
    dev_ms = time_ms(sealed.graph.replay, 3, warmup=1)
    say(f"  host clock, batch copied in, synchronised per step: eager {eager_med:.3f} ms/step "
        f"({tokens / eager_med * 1e3:,.0f} tok/s), sealed replay {replay_med:.3f} ms/step "
        f"({tokens / replay_med * 1e3:,.0f} tok/s); one replay on CUDA events {dev_ms:.3f} ms")

    events = kernels_in_replay(lambda: sealed())
    rows = sorted(by_kernel(events), reverse=True)
    total_us = sum(us for us, _, _ in rows)
    b7_kinds = {k: sum(1 for e in events if k in e.name) for k in B7_KERNELS}
    b7_us = {k: sum(us for us, _, key in rows if k in key) for k in B7_KERNELS}
    shares = {name: sum(us for us, _, key in rows if any(w in key for w in words))
              for name, words in (("B2", ("stream_pack",)), ("B4", B4_KERNELS),
                                  ("B5", B5_KERNELS))}
    gemm = sum(us for us, _, key in rows if any(w in key.lower() for w in GEMM_NAMES))
    say(f"  one profiled replay: {sum(c for _, c, _ in rows)} device kernels, "
        f"{total_us / 1e3:.3f} ms of kernel time: B7 {sum(b7_us.values()) / 1e3:.3f} ms "
        f"({sum(b7_us.values()) / total_us:.1%}: "
        + ", ".join(f"{k} x{b7_kinds[k]} {v / 1e3:.3f} ms" for k, v in b7_us.items()) + "), "
        + ", ".join(f"{k} {v / 1e3:.3f} ms ({v / total_us:.1%})" for k, v in shares.items())
        + f", cuBLAS products {gemm / 1e3:.3f} ms ({gemm / total_us:.1%}); top:")
    for us, count, key in rows[:8]:
        say(f"      {us / 1e3:9.3f} ms x{count:4d}  {key[:90]}")
    b2_rows = [(b2_variant(key), count, us) for us, count, key in rows if "stream_pack" in key]
    say("  B2's kernels in the replay, by variant: " + "; ".join(
        f"{v} x{count} {us / 1e3:.3f} ms" for v, count, us in b2_rows))
    want_kinds = {k: cfg.n_layers for k in B7_KERNELS}
    if b7_kinds != want_kinds:
        fail(f"a replay ran B7's kernels {b7_kinds}, not {want_kinds}")
    check_norm_rope(rows, cfg, "training replay", backward=True, again=lambda: sealed(),
                    captured=captured)
    # the forward's gate, up and down and each one's dx and dw, a layer
    b2_want = {f"bf16_wgmma/{lay}": 3 * cfg.n_layers for lay in ("nn", "nt", "tn")}
    b2_got = {v: count for v, count, _ in b2_rows}
    if b2_got != b2_want:
        fail(f"a replay ran B2's kernels {b2_got}, not {b2_want}")
    B7_REPLAYS["replays"] += 1
    B7_REPLAYS["kernels"] += sum(b7_kinds.values())
    B7_REPLAYS["calls"] += 2 * cfg.n_layers         # the capture's forward and backward calls
    del sealed, model, state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(eager_ms=eager_med, replay_ms=replay_med, replay_device_ms=dev_ms,
                tokens_per_step=tokens, tokens_per_s=tokens / replay_med * 1e3, seal_s=seal_s,
                eager_peak_gib=eager_peak / 2**30, seal_peak_gib=seal_peak / 2**30,
                losses=losses, b7_launches=b7.launches + b7_bwd.launches,
                b2_launches=pack.launches, in_replay=b7_kinds,
                b7_replay_ms={k: v / 1e3 for k, v in b7_us.items()},
                b2_replay={v: dict(kernels=count, ms=us / 1e3) for v, count, us in b2_rows},
                shares_ms={k: v / 1e3 for k, v in shares.items()},
                replay_kernel_ms=total_us / 1e3, parameters=n, leaves=leaves, chains=chains,
                # for 21f, on the host (the card holds one such model at a
                # time): the eager steps', which the first replays equal
                reference=dict(loss=eager_loss, gnorm=eager_gnorm, params=eager_params,
                               eager_ms=eager_med, replay_ms=replay_med,
                               replay_device_ms=dev_ms, b2=eager[2], b7=eager[:2],
                               b4=eager[3], b5=eager[4]))


def b2_variant(name: str) -> str:
    """The variant of the B2 kernel a profiler names (the wgmma kernel's
    template arguments are x and w transposed), else the name itself."""
    found = re.search(r"stream_pack_wgmma<(\w+), (\w+)>", name)
    if not found:
        return name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
    return "bf16_wgmma/" + "".join("t" if f == "true" else "n" for f in found.groups())


def train_card_vs_cpu() -> dict:
    """19d: one sealed training step of the phi4-mini, arctic and
    deepseek-v2 smoke configs at float32 on the card against the same step
    on the CPU, one set of weights: loss and grad norm within
    ``TRAIN_RTOL``, every parameter within ``TRAIN_PARAM_ATOL_LR`` x lr.
    B1's and B2's gradients run inside a real step here."""
    import torch

    import repro_torch.configs as C
    from repro_torch.data import SyntheticLM, data_config_for
    from repro_torch.kernels.adamw import kernel as b4
    from repro_torch.kernels.cross_entropy import kernel as b5
    from repro_torch.kernels.expanded_attention import backward as b7_bwd
    from repro_torch.kernels.expanded_attention import kernel as b7
    from repro_torch.kernels.flash_attention import backward, kernel
    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.launch import serve
    from repro_torch.models import Transformer
    from repro_torch.optim import adamw_init
    from repro_torch.training import make_train_step, seal_train_step

    lr = 1e-3
    say(f"-- 19d: card against CPU, one sealed step at float32 (lr {lr}): loss and grad norm "
        f"within {TRAIN_RTOL} relative, parameters within {TRAIN_PARAM_ATOL_LR} x lr")
    counts = {}
    for arch in SMOKE_TRAIN_ARCHS:
        cfg = dataclasses.replace(C.get(arch, smoke=True), dtype="float32")
        batch = SyntheticLM(data_config_for(cfg, batch_size=TRAIN_BATCH, seq_len=64)).batch(0)
        on_card = serve.init_params(cfg, seed=5, device="cuda")
        on_cpu = Transformer(cfg, device="cpu")
        on_cpu.load_state_dict(on_card.state_dict())
        step = make_train_step(cfg, lr=lr)
        before = (kernel.launches, backward.launches, pack.launches, b4.launches, b5.launches,
                  b7.launches, b7_bwd.launches)
        copies = pack.layout_copies
        got = {}
        for dev, model in (("cuda", on_card), ("cpu", on_cpu)):
            sealed = seal_train_step(step, model, adamw_init(dict(model.named_parameters())),
                                     batch)
            m = sealed(batch)
            got[dev] = {k: float(v) for k, v in m.items()}
            if dev == "cuda" and sealed.graph is None:
                fail(f"{arch}: the step on the card was not sealed as a CUDA graph")
        counts[arch] = tuple(c1 - c0 for c1, c0 in zip(
            (kernel.launches, backward.launches, pack.launches, b4.launches, b5.launches,
             b7.launches, b7_bwd.launches), before))
        perr = max((a.detach().cpu() - b.detach()).abs().max().item()
                   for a, b in zip(on_card.parameters(), on_cpu.parameters()))
        rel = max(abs(got["cuda"][k] - got["cpu"][k]) / max(abs(got["cpu"][k]), 1e-12)
                  for k in ("loss", "grad_norm"))
        say(f"  {cfg.name}: card {got['cuda']} | cpu {got['cpu']} | loss/grad norm "
            f"{rel:.2e} relative, parameters max |diff| {perr:.3e} | wrapper calls on the card "
            f"(B1 forward, B1 backward, B2; B4 kernels, B5 kernels; B7 forward, B7 backward) "
            f"{counts[arch]}")
        if not (rel <= TRAIN_RTOL and perr <= TRAIN_PARAM_ATOL_LR * lr):
            fail(f"{cfg.name}: the step on the card differs from the CPU's")
        if arch != "deepseek-v2-236b" and min(counts[arch][:2]) == 0:
            fail(f"{cfg.name}: the step on the card never launched B1 or its backward")
        if cfg.moe is not None and counts[arch][2] == 0:
            fail(f"{cfg.name}: the step on the card never launched B2")
        if cfg.mla is not None and counts[arch][5:] != (2 * cfg.n_layers,) * 2:
            fail(f"{cfg.name}: the seal launched B7 {counts[arch][5:]} times, not its warm-up's "
                 f"and its capture's {cfg.n_layers} forward and backward calls each")
        if pack.layout_copies != copies:
            fail(f"{cfg.name}: the step made {pack.layout_copies - copies} B2 layout copies "
                 "(its backward reads w^T and x^T where they lie)")
        leaves = len(list(on_card.parameters()))
        if counts[arch][3] != 2 * leaves + 1:
            fail(f"{cfg.name}: the sealed step launched {counts[arch][3]} B4 kernels, not the "
                 f"capture's {2 * leaves + 1}")
        if counts[arch][4] != 4:
            fail(f"{cfg.name}: the seal launched {counts[arch][4]} B5 kernels, not 4 (its "
                 f"warm-up's and its capture's partials and backward)")
    return counts


def train_nimble_grads() -> dict:
    """19e: Nimble over ``torch.func.grad`` of the four branchy cells'
    squared-output loss at full size, float32: single-stream, multi-stream
    and packed replays against eager torch.func, µs per call."""
    import torch

    from repro_torch.configs import branchy_cell
    from repro_torch.core import Nimble
    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.models.branchy import branchy_forward, example_input, init_branchy

    say(f"-- 19e: Nimble on the branchy cells' gradients (torch.func.grad of sum(out**2)), "
        f"full size, float32, against eager torch.func within {GRAD_TOL}")
    pack.launches = 0
    record = {}
    for cfg in (branchy_cell.darts_like(), branchy_cell.nasnet_mobile_like(),
                branchy_cell.amoebanet_like(), branchy_cell.inception_like()):
        params = init_branchy(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
        x = example_input(cfg, 0, device="cuda")

        def loss(p, x, _cfg=cfg):
            return (branchy_forward(p, x, _cfg) ** 2).sum()

        grad = torch.func.grad(loss)
        ref = {k: v.clone() for k, v in grad(params, x).items()}
        engines = {"eager": lambda: grad(params, x)}
        groups, checks = None, []
        for name, kw in (("single_stream", dict(multi_stream=False)), ("multi_stream", {}),
                         ("packed", dict(pack_streams=True))):
            nimble = Nimble(grad, params, x, **kw)
            engines[name] = lambda n=nimble: n(params, x)
            got = engines[name]()
            torch.cuda.synchronize()
            elementwise = max(ratio(got[k], ref[k], *GRAD_TOL[name]) for k in ref)
            atol, rtol = GRAD_TOL[name]
            scaled = max((got[k] - ref[k]).abs().max().item()
                         / (atol + rtol * ref[k].abs().max().item()) for k in ref)
            r = scaled if name == "packed" else elementwise
            checks.append(f"{name} {elementwise:.3f} element-wise, {scaled:.3f} scaled")
            if not r <= 1.0:
                fail(f"{cfg.name} gradient {name} differs from eager: {r:.3f} of tolerance")
            if name == "packed":
                groups = nimble.schedule.pack_report.groups
        st = nimble.stats
        us = {name: time_ms(run, 100, warmup=5) * 1e3 for name, run in engines.items()}
        say(f"  {cfg.name}: {st.num_tasks} tasks, {st.num_streams} streams, degree "
            f"{st.degree_of_concurrency}, pack groups {groups}; us per call: "
            + " | ".join(f"{k} {v:.2f}" for k, v in us.items())
            + f" | eager/multi {us['eager'] / us['multi_stream']:.3f}x | of tolerance: "
            + ", ".join(checks))
        record[cfg.name] = us
    record["b2_launches"] = pack.launches
    say(f"  stream_pack wrapper calls on the packed gradient schedules: {pack.launches}")
    return record


def phase_train(number: int) -> dict:
    """Phase 19: training on the card (19a, 19b, 19f, 19g, 19c, 19d, 19h, 19e)."""
    from repro_torch.kernels.flash_attention import backward

    say(f"== phase {number}: training on the card")
    release()           # the engines of phases 16-18, held in reference cycles
    train_kernel_sweep()
    bwd_record = train_kernel_timing()
    pack_record = train_b2_backward()
    adamw_record = train_adamw()
    ce_record = train_ce()
    with train_path("train phi4-mini-3.8b (eager steps, seal)"):
        phi4 = train_phi4()
    backward.launches = 0
    with train_path("train smoke configs on the card"), \
            b7_path("train smoke configs on the card (19d)"):
        smoke = train_card_vs_cpu()
    with train_path("train deepseek-v2-236b 1 layer (eager steps, seal)"), \
            b7_path("train deepseek-v2-236b 1 layer (19h: eager steps, seal)"), \
            b2_path("train deepseek-v2-236b 1 layer (19h)"):
        deepseek = train_deepseek()
    nimble = train_nimble_grads()
    return dict(bwd=bwd_record, pack=pack_record, adamw=adamw_record, ce=ce_record, phi4=phi4,
                smoke=smoke, deepseek=deepseek, nimble=nimble)


# phase 20: decode_32k's per-device share (128 sequences over the 16-way data
# axis), and the synchronized steps run eagerly and as graph replays
SYNC_BATCH, SYNC_STEPS = 8, 8
# the dry run's subprocesses at a time, on the host's CPU (8 cores beside
# the card), while phase 20 draws its model's weights
DRYRUN_PROCS = 6
# the cases whose MoE 20a reports apart, on both meshes
DRYRUN_MOE = ("deepseek-v2-236b_train_4k", "deepseek-v2-236b_prefill_32k", "arctic-480b_train_4k",
              "arctic-480b_prefill_32k")


class DryRun:
    """``python -m repro_torch.launch.dryrun --both-meshes`` over every arch
    and applicable shape, in subprocesses (CPU only: meta tensors) started
    by a thread, at most :data:`DRYRUN_PROCS` at a time: one per arch, and
    one per shape and mesh for xlstm-125m, whose sLSTM steps through every
    position of train_4k and prefill_32k (in the partitioned pass too,
    three times a mesh).  Their output goes to
    ``build/dryrun_torch/*.log``, their records to
    ``experiments/dryrun_torch/``.  :meth:`stop` kills what still runs."""

    def __init__(self) -> None:
        import threading

        import repro_torch.configs as C
        from repro_torch.configs.shapes import INPUT_SHAPES

        base = [sys.executable, "-m", "repro_torch.launch.dryrun"]
        self.cmds = [base + ["--arch", "xlstm-125m", "--shape", s] + pod
                     for s in INPUT_SHAPES for pod in ([], ["--multi-pod"])] + [
            base + ["--both-meshes", "--arch", a] for a in C.all_archs() if a != "xlstm-125m"]
        self.logs = ROOT / "build" / "dryrun_torch"
        self.logs.mkdir(parents=True, exist_ok=True)
        self.procs: list = []
        self.stopped = False
        self.t0 = time.perf_counter()
        self.thread = threading.Thread(target=self._start_all, name="dryrun", daemon=True)
        self.thread.start()

    def _start_all(self) -> None:
        import os

        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
        for i, cmd in enumerate(self.cmds):
            while (not self.stopped
                   and sum(p.poll() is None for _, p, _ in self.procs) >= DRYRUN_PROCS):
                time.sleep(0.2)
            if self.stopped:
                return
            log = self.logs / f"{i:02d}.log"
            with open(log, "w") as out:
                proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, cwd=ROOT,
                                        env=env)
            self.procs.append((cmd, proc, log))

    def wait(self, timeout: float) -> list[tuple[list, int, str]]:
        """``(command, exit code, output)`` of every process, once all have
        ended; a process still running at ``timeout`` fails the run."""
        deadline = time.perf_counter() + timeout
        self.thread.join(max(0.0, deadline - time.perf_counter()))
        out = []
        for cmd, proc, log in self.procs:
            try:
                rc = proc.wait(max(0.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                fail(f"the dry run {' '.join(cmd[2:])} is still running after {timeout:.0f}s")
            out.append((cmd, rc, log.read_text()))
        if len(out) != len(self.cmds):
            fail(f"only {len(out)} of the dry run's {len(self.cmds)} processes started")
        return out

    def stop(self) -> None:
        self.stopped = True
        self.thread.join(timeout=10.0)
        for _, proc, _ in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def dryrun_report(dry: DryRun) -> dict:
    """20a: every dry-run case's line; fails on a failed process, a FAIL
    line, a case missing (each applicable arch x shape on both meshes) or a
    case whose step did not partition (every case has its per-device
    FLOPs, bytes accessed, temp, output and collective bytes).  The MoE
    cases' temps, ``fits`` and collective bytes by kind are printed again
    together (``DRYRUN_MOE``)."""
    import torch

    import repro_torch.configs as C
    from repro_torch.configs.shapes import INPUT_SHAPES, applicable

    say("-- 20a: the dry run on the meta device, every arch x applicable shape x production "
        "mesh (16x16, 2x16x16): bytes per device of params, AdamW moments, cache and batch, "
        "the step's FLOPs (FlopCounterMode); the partitioned step per device (CommCounter "
        "over a fake process group): FLOPs, bytes accessed, temp and output bytes (fits: "
        "argument + temp + output within the card's 80 GB), collective bytes")
    results = dry.wait(timeout=600.0)
    ok, unpartitioned = [], []
    for cmd, rc, text in results:
        for line in text.splitlines():
            if line.startswith(("OK", "FAIL", "SKIP")):
                say(f"  {line}")
                if line.startswith("OK"):
                    ok.append(line.split()[1].rstrip(":"))
                    if "partitioned=false" in line or not all(
                            f" {key}=" in line for key in ("accessed", "temp", "output")):
                        unpartitioned.append(ok[-1])
        if rc != 0:
            fail(f"the dry run {' '.join(cmd[2:])} exited {rc}: {text[-2000:]}")
    want = {f"{a}_{s}_{m}" for a in C.all_archs() for s in INPUT_SHAPES
            if applicable(C.get(a), s) for m in ("16x16", "2x16x16")}
    if set(ok) != want or len(ok) != len(want):
        fail(f"the dry run's cases differ from every applicable one: missing "
             f"{sorted(want - set(ok))}, unexpected {sorted(set(ok) - want)}")
    if unpartitioned:
        fail(f"the dry run did not partition {unpartitioned}")
    wall = time.perf_counter() - dry.t0
    say(f"  {len(ok)} cases passed and partitioned in {len(results)} processes, {wall:.1f}s "
        f"from their start")
    moe = {}
    for tag in DRYRUN_MOE:
        for mesh in ("16x16", "2x16x16"):
            r = json.loads((ROOT / "experiments" / "dryrun_torch" / f"{tag}_{mesh}.json")
                           .read_text())
            m, c = r["memory"], r["collectives"]
            moe[f"{tag}_{mesh}"] = dict(
                argument_gib=m["argument_bytes"] / 2**30, temp_gib=m["temp_bytes"] / 2**30,
                fits=m["fits"], collectives_gib={k: v / 2**30 for k, v in
                                                 c["bytes_per_kind"].items() if v})
    lines = [f"{tag} temp {r['temp_gib']:.3f} GiB (arguments {r['argument_gib']:.3f}), fits "
             f"{r['fits']}, collectives GiB "
             + ", ".join(f"{k} {v:.1f}" for k, v in r["collectives_gib"].items())
             for tag, r in moe.items()]
    say(f"  the MoE cases, each device routing its own tokens (torch {torch.__version__}): "
        + "; ".join(lines))
    return dict(cases=len(ok), wall_s=wall, moe=moe)


def synced_decode(cfg, model) -> dict:
    """20b: decode_32k at one device's share: B = 8 sequences over a
    ``per_slot=False`` cache of 32768 positions, filled from a seeded
    generator, ``pos`` near its end.  The synchronized step's logits must
    equal the per-slot step's on the same state with ``pos`` broadcast;
    then SYNC_STEPS greedy steps eagerly and as replays of one captured
    step, the same tokens.  Between runs only the positions the steps
    write, and ``pos``, are restored: there is no room for a second cache."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import decode_step, init_cache

    B, T = SYNC_BATCH, LONG_PROMPT
    torch.cuda.reset_peak_memory_stats()
    cache = init_cache(cfg, B, T, per_slot=False, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(20)
    for name in ("k", "v"):
        for layer in cache[name]:              # a layer at a time: no 34 GB temporary
            layer.copy_(torch.randn(layer.shape, generator=g, device="cuda", dtype=layer.dtype))
    cache_gb = sum(cache[n].numel() * cache[n].element_size() for n in ("k", "v")) / 1e9
    p0 = T - 2 * SYNC_STEPS
    written = slice(p0, p0 + SYNC_STEPS)
    saved = {n: cache[n][:, :, written].clone() for n in ("k", "v")}

    def restore():
        for n in ("k", "v"):
            cache[n][:, :, written].copy_(saved[n])
        cache["pos"].fill_(p0)

    def step(tok):
        logits, _ = decode_step(model, cache, tok, cfg)
        return torch.argmax(logits[:, -1, : cfg.vocab], dim=-1)

    first = _tokens(cfg, B, 1, seed=21)
    before = flash.launches
    say(f"-- 20b: synchronized decode, phi4-mini-3.8b full, bf16: B = {B} (decode_32k's 128 "
        f"over the 16-way data axis; its 8 kv heads do not divide the 16-way model axis, so "
        f"the cache is whole), cache of {T} positions, {cache_gb:.1f} GB, pos 0-d at {p0}")
    with torch.no_grad():
        restore()
        synced, _ = decode_step(model, cache, first, cfg)
        restore()
        per_slot = {"k": cache["k"], "v": cache["v"],
                    "pos": torch.full((B,), p0, dtype=torch.long, device="cuda")}
        slotted, _ = decode_step(model, per_slot, first, cfg)
        torch.cuda.synchronize()
        diff = (synced - slotted).abs().max().item()
        same = torch.equal(synced, slotted)
        del synced, slotted, per_slot
        say(f"  synchronized logits against the per-slot step's on the same state: max |diff| "
            f"{diff:.3e}, {'equal' if same else 'NOT equal'}")
        if not same:
            fail("the synchronized step's logits differ from the per-slot step's")

        restore()
        tok, eager = first.clone(), []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SYNC_STEPS):
            nxt = step(tok)
            eager.append(nxt)
            tok = nxt[:, None]
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / SYNC_STEPS * 1e3
        eager = torch.stack(eager, 1).cpu()
        if int(cache["pos"]) != p0 + SYNC_STEPS:
            fail(f"pos is {int(cache['pos'])} after {SYNC_STEPS} steps from {p0}")

        restore()
        tok_in = first.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(tok_in)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        restore()
        graph = torch.cuda.CUDAGraph()
        with capture(graph):
            out = step(tok_in)
        got = []
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(SYNC_STEPS):
            graph.replay()
            got.append(out.clone())
            tok_in.copy_(out[:, None])
        stop.record()
        stop.synchronize()
        replay_ms = start.elapsed_time(stop) / SYNC_STEPS
        got = torch.stack(got, 1).cpu()
    say(f"  {SYNC_STEPS} greedy steps: eager {eager_ms:.3f} ms a step (host clock), graph "
        f"replay {replay_ms:.3f} ms a step (CUDA events, with the token feed)")
    say(f"  tokens eager {eager.tolist()}")
    say(f"  tokens graph {got.tolist()}")
    if not torch.equal(eager, got):
        fail("the captured synchronized step gives other tokens than the eager one")
    if eager.min() < 0 or eager.max() >= cfg.vocab:
        fail(f"a token outside [0, {cfg.vocab})")

    def replay():
        restore()
        tok_in.copy_(first)
        graph.replay()
        return out

    rows = by_kernel(kernels_in_one(replay))
    if not rows:
        fail("the profiler saw no device time in a synchronized decode replay")
    total = sum(us for us, _, _ in rows)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"  one replay (after the copies that restore its state): {sum(c for _, c, _ in rows)} "
        f"device ops, {total / 1e3:.3f} ms of kernels; peak memory {peak:.2f} GiB; top:")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        say(f"  {us / total:6.1%} {us / 1e3:8.3f} ms x{count:<4d} {key[:90]}")
    b3 = check_b3_replay(rows, cfg.n_layers, "synchronized decode replay")
    launches = flash.launches - before
    if launches:
        fail(f"the synchronized decode launched B1 {launches} times: its attention is B3's")
    del graph, cache, saved
    return dict(batch=B, cache_positions=T, cache_gb=cache_gb, eager_step_ms=eager_ms,
                replay_ms=replay_ms, replay_kernels_ms=total / 1e3, peak_gib=peak,
                logits_equal_per_slot=same, b3_in_replay=b3)


def prefill_32k(cfg, model) -> dict:
    """20c: ``forward`` of one 32768-token prompt (prefill_32k's share is 2
    of its 32 sequences a device: B = 1 is a cut): every layer's attention
    on B1 at q (1, 32768, 24, 128), kv 8 heads, causal, at a shape phase 3
    checked; finite logits; the time (CUDA events) and the peak memory."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import forward

    say(f"-- 20c: prefill_32k, phi4-mini-3.8b full, bf16, B = 1 (a cut: the per-device share "
        f"is 2), {LONG_PROMPT} tokens")
    batch = {"tokens": _tokens(cfg, 1, LONG_PROMPT, seed=22)}
    seen: set = set()
    before = flash.launches
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), b1_calls(seen):
        logits, _ = forward(model, batch, cfg)
        torch.cuda.synchronize()
    made = flash.launches - before
    peak = torch.cuda.max_memory_allocated() / 2**30
    finite = bool(torch.isfinite(logits).all())
    shape = tuple(logits.shape)
    del logits
    say(f"  logits {shape} float32 ({shape[1] * shape[2] * 4 / 1e9:.1f} GB), "
        f"{'finite' if finite else 'NOT finite'}; {made} B1 launches; peak {peak:.2f} GiB")
    if shape != (1, LONG_PROMPT, cfg.padded_vocab) or not finite:
        fail(f"prefill_32k: logits {shape} not finite or not (1, {LONG_PROMPT}, vocab)")
    if made != cfg.n_layers:
        fail(f"prefill_32k: B1 launched {made} times, want {cfg.n_layers}")
    check_family_launches(seen, "phase 20c")
    with torch.no_grad():
        ms = time_ms(lambda: forward(model, batch, cfg)[0], 2, warmup=1)
    launches = flash.launches - before
    say(f"  {ms:.3f} ms a forward (CUDA events, mean of 2 after 1), "
        f"{LONG_PROMPT / ms * 1e3:,.0f} tokens/s; B1 launched {launches} times in 20c")
    return dict(ms=ms, peak_gib=peak, launches=launches)


def phase_launch(number: int) -> dict:
    """Phase 20: the launch layer (the dry run, the synchronized decode and
    prefill_32k); see the module docstring.  The dry run's processes load
    the host's cores, so they run while the model is drawn and have ended
    before 20b and 20c time anything."""
    say(f"== phase {number}: the launch layer")
    dry = DryRun()
    try:
        cfg, model = _load(LONG_ARCH, f"{number}b, {number}c")
        report = dryrun_report(dry)
    finally:
        dry.stop()
    decode = synced_decode(cfg, model)
    release()
    prefill = prefill_32k(cfg, model)
    del model
    release()
    return dict(dryrun=report, decode=decode, prefill=prefill)


# phase 21: sharded execution on one card, a (1, 1) mesh: deepseek-v2's
# prompt batch for the serving-path forward
SHARDED_PROMPT = (2, 256)


def sharded_train(mesh, ref: dict) -> dict:
    """21a: phase 19c's phi4-mini-3.8b step with the parameters and AdamW
    state as DTensors on ``mesh``: eager steps against 19c's, then the step
    sealed as one CUDA graph and replayed against 19c's replays from the
    same state and batches: losses, grad norms and parameters bit for bit.
    B1 forward and backward run through ``local_map``; no collective runs
    and B1 copies no input."""
    import gc

    import numpy as np
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    import repro_torch.configs as C
    from repro_torch.data import SyntheticLM, data_config_for, shard_batch
    from repro_torch.distributed import shard_model
    from repro_torch.kernels.adamw import kernel as b4
    from repro_torch.kernels.cross_entropy import kernel as b5
    from repro_torch.kernels.flash_attention import backward, kernel, ops
    from repro_torch.launch import serve
    from repro_torch.models import param_axes
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.training import make_train_step, seal_train_step

    release()
    cfg = dataclasses.replace(C.get("phi4-mini-3.8b"), dtype="bfloat16")
    data = SyntheticLM(data_config_for(cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ))
    n_steps = TRAIN_EAGER + SHARDED_TIMED
    batches = [data.batch(i) for i in range(n_steps)]

    def lr(step):
        return cosine_schedule(step, peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                               total_steps=TRAIN_REPLAYS)

    def fresh():
        model = serve.init_params(cfg, seed=0, device="cuda")
        shard_model(model, param_axes(cfg), mesh)
        return model, adamw_init(dict(model.named_parameters()))

    step_fn = make_train_step(cfg, lr=lr, mesh=mesh)
    model, state = fresh()
    first = next(model.parameters())
    say(f"-- 21a: phase 19c's step with the {sum(1 for _ in model.parameters())} parameters "
        f"as DTensors ({type(first).__name__}, placements {first.placements}) and AdamW's "
        f"moments on their placements, step counter {type(state.step).__name__} "
        f"{state.step.placements}")

    # eager steps: DTensor's dispatch on the host around the same kernels
    kernel.launches = backward.launches = ops.on_shards = 0     # the path's run starts here
    b4_start, b5_start = b4.launches, b5.launches
    copies = kernel.layout_copies
    eager_loss, eager_gnorm, eager_ms = [], [], []
    with CommDebugMode() as comm:
        for i in range(TRAIN_EAGER):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = step_fn(model, state, shard_batch(batches[i], mesh, "cuda"))[2]
            eager_loss.append(float(m["loss"]))
            eager_ms.append((time.perf_counter() - t) * 1e3)
            eager_gnorm.append(float(m["grad_norm"]))
            del m
    eager_counts = (kernel.launches, backward.launches)
    eager_b4, eager_b5 = b4.launches - b4_start, b5.launches - b5_start
    say(f"  eager steps: loss {eager_loss} (19c {ref['eager_loss']}), grad norm {eager_gnorm} "
        f"(19c {ref['eager_gnorm']}), ms {[round(x, 3) for x in eager_ms]}; B1 forward, "
        f"backward launches {eager_counts} (19c {ref['eager_counts']}), through local_map "
        f"{ops.on_shards}; B4 kernels on the local shards {eager_b4} (19c {ref['eager_b4']}); "
        f"B5 kernels on the local logits {eager_b5} (19c {ref['eager_b5']}); collectives "
        f"{comm.get_total_counts()}")
    if eager_b4 != ref["eager_b4"] or eager_b5 != ref["eager_b5"]:
        fail(f"the sharded eager steps launched {eager_b4} B4 and {eager_b5} B5 kernels, 19c "
             f"{ref['eager_b4']} and {ref['eager_b5']}")
    if (eager_loss, eager_gnorm) != (ref["eager_loss"], ref["eager_gnorm"]):
        fail("the sharded eager steps differ from 19c's bit for bit")
    if eager_counts != ref["eager_counts"] or ops.on_shards != eager_counts[0]:
        fail(f"the sharded eager steps launched B1 {eager_counts}, {ops.on_shards} through "
             f"local_map; 19c {ref['eager_counts']}")
    if comm.get_total_counts():
        fail(f"a (1, 1) mesh ran collectives: {dict(comm.get_comm_counts())}")
    del model, state
    gc.collect()
    torch.cuda.empty_cache()

    # sealed, from the same state: 19c's replays bit for bit
    model, state = fresh()
    sealed = seal_train_step(step_fn, model, state, batches[0])
    seal_counts = (kernel.launches - eager_counts[0], backward.launches - eager_counts[1])
    seal_b4 = b4.launches - b4_start - eager_b4
    seal_b5 = b5.launches - b5_start - eager_b5
    copies = kernel.layout_copies - copies
    say(f"  sealed as one CUDA graph in {sealed.seal_s:.2f}s; B1 launches by the seal "
        f"{seal_counts} (19c {ref['seal_counts']}); B4 kernels by the seal {seal_b4} (19c "
        f"{ref['seal_b4']}); B5 kernels by the seal {seal_b5} (19c {ref['seal_b5']}); layout "
        f"copies over the phase {copies}")
    if (seal_counts != ref["seal_counts"] or copies or seal_b4 != ref["seal_b4"]
            or seal_b5 != ref["seal_b5"]):
        fail(f"the sharded seal launched B1 {seal_counts} (19c {ref['seal_counts']}), B4 "
             f"{seal_b4} (19c {ref['seal_b4']}), B5 {seal_b5} (19c {ref['seal_b5']}), layout "
             f"copies {copies}")
    losses, gnorms, replay_ms = [], [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = sealed(batches[i])
        losses.append(float(m["loss"]))
        replay_ms.append((time.perf_counter() - t) * 1e3)
        gnorms.append(float(m["grad_norm"]))
        if i == TRAIN_EAGER - 1:
            same = total = 0
            for p, want in zip(model.parameters(), ref["params"]):
                same += int((p.to_local().cpu() == want).sum())
                total += want.numel()
            say(f"  {TRAIN_EAGER} replays: loss {losses} (19c {ref['replay_loss']}), grad norm "
                f"{gnorms} (19c {ref['replay_gnorm']}); parameters {same} of {total} "
                f"bit-identical to 19c's after as many replays")
            if (losses, gnorms) != (ref["replay_loss"], ref["replay_gnorm"]) or same != total:
                fail("the sharded replays differ from 19c's bit for bit")
    eager_med = float(np.median(eager_ms[1:]))
    replay_med = float(np.median(replay_ms[TRAIN_EAGER:]))
    dev_ms = time_ms(sealed.graph.replay, 5, warmup=1)
    say(f"  ms per step (host clock, batch copied in): eager {eager_med:.3f} (19c "
        f"{ref['eager_ms']:.3f}: DTensor's host dispatch adds {eager_med - ref['eager_ms']:.3f}), "
        f"sealed replay {replay_med:.3f} (19c {ref['replay_ms']:.3f}); one replay on CUDA "
        f"events {dev_ms:.3f} (19c {ref['replay_device_ms']:.3f})")
    del sealed, model, state
    return dict(fwd_launches=kernel.launches, bwd_launches=backward.launches,
                on_shards=ops.on_shards, eager_ms=eager_med, replay_ms=replay_med,
                replay_device_ms=dev_ms, dtensor_host_ms=eager_med - ref["eager_ms"])


def sharded_forward(mesh) -> dict:
    """21b: deepseek-v2-236b at full width and 2 layers, bf16: one forward of
    a prompt batch, then the same with the parameters and the batch as
    DTensors on ``mesh``: logits bit for bit, the three expert GEMMs of each
    layer on B2 through ``local_map``.  The prompt's 512 tokens take the
    capacity path (24 slots an expert), routed on the device's tokens."""
    import torch

    import repro_torch.configs as C
    from repro_torch.distributed import batch_axes, shard_model, shard_tree, use_sharding_ctx
    from repro_torch.kernels.expanded_attention import backward as b7_bwd
    from repro_torch.kernels.expanded_attention import kernel as b7
    from repro_torch.kernels.stream_pack import kernel as pack_kernel
    from repro_torch.kernels.stream_pack import ops as pack_ops
    from repro_torch.launch import serve
    from repro_torch.models import forward, param_axes

    release()
    cfg = dataclasses.replace(C.get("deepseek-v2-236b"), n_layers=2, dtype="bfloat16")
    model = serve.init_params(cfg, seed=0, device="cuda")
    batch = {"tokens": _tokens(cfg, *SHARDED_PROMPT, seed=21)}
    with torch.no_grad():
        want = forward(model, batch, cfg)[0]
        torch.cuda.synchronize()
        shard_model(model, param_axes(cfg), mesh)
        placed = shard_tree(batch, batch_axes(batch), mesh)
        # the path's run starts here: the unsharded forward above is not its
        pack_kernel.launches = pack_ops.on_shards = b7.launches = b7_bwd.launches = 0
        with use_sharding_ctx(mesh):
            t = time.perf_counter()
            got = forward(model, placed, cfg)[0]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
    launches, on_shards = pack_kernel.launches, pack_ops.on_shards
    b7_sharded = b7.launches + b7_bwd.launches
    same = bool(torch.equal(got.to_local(), want))
    say(f"-- 21b: {cfg.name}, full width, {cfg.n_layers} layers, bf16, a forward of "
        f"{SHARDED_PROMPT[0]} x {SHARDED_PROMPT[1]} tokens with DTensor parameters: logits "
        f"{tuple(got.shape)} bit-identical to the unsharded forward's: {same}; B2 launches "
        f"{launches}, through local_map {on_shards} (want 3 x {cfg.n_layers}); B7 (MLA's "
        f"expanded form) {b7_sharded} (want {cfg.n_layers}); {ms:.3f} ms (host clock, first "
        f"call)")
    if not same or launches != 3 * cfg.n_layers or on_shards != launches:
        fail("the sharded forward differs from the unsharded one or missed B2")
    if b7_sharded != cfg.n_layers:
        fail(f"the sharded forward launched B7 {b7_sharded} times, not once a layer")
    del model, want, got
    return dict(b2_launches=launches, on_shards=on_shards, forward_ms=ms)


def sharded_train_deepseek(mesh, ref: dict) -> dict:
    """21f: phase 19h's step (deepseek-v2-236b at full width, 1 of 60
    layers, bf16, AdamW, 2 x 4096 tokens from ``SyntheticLM``) with the
    parameters, AdamW state and batch as DTensors on ``mesh``, the MoE
    routing each device's tokens: eager steps against 19h's, then the step
    sealed as one CUDA graph and replayed from the same state against
    19h's replays (which equal its eager steps): losses, grad norms and
    parameters bit for bit; every B2 launch from a call through
    ``local_map``; B7, B4 and B5 launched as in 19h; no collective."""
    import gc

    import numpy as np
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    import repro_torch.configs as C
    from repro_torch.data import SyntheticLM, data_config_for, shard_batch
    from repro_torch.distributed import shard_model
    from repro_torch.kernels.adamw import kernel as b4
    from repro_torch.kernels.cross_entropy import kernel as b5
    from repro_torch.kernels.expanded_attention import backward as b7_bwd
    from repro_torch.kernels.expanded_attention import kernel as b7
    from repro_torch.kernels.stream_pack import kernel as pack
    from repro_torch.kernels.stream_pack import ops as pack_ops
    from repro_torch.launch import serve
    from repro_torch.models import param_axes
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.training import make_train_step, seal_train_step

    release()
    cfg = dataclasses.replace(C.get("deepseek-v2-236b"), n_layers=TRAIN_MLA_LAYERS,
                              dtype="bfloat16")
    data = SyntheticLM(data_config_for(cfg, batch_size=TRAIN_MLA_BATCH, seq_len=TRAIN_MLA_SEQ))
    batches = [data.batch(i) for i in range(TRAIN_EAGER)]

    def lr(step):
        return cosine_schedule(step, peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                               total_steps=TRAIN_MLA_REPLAYS)

    def fresh():
        model = serve.init_params(cfg, seed=0, device="cuda")
        shard_model(model, param_axes(cfg), mesh)
        return model, adamw_init(dict(model.named_parameters()))

    def counts():
        return (b7.launches, b7_bwd.launches, pack.launches, b4.launches, b5.launches,
                pack_ops.on_shards)

    def same_params(model) -> tuple[int, int]:
        same = total = 0
        for p, want in zip(model.parameters(), ref["params"]):
            same += int((p.to_local().cpu() == want).sum())
            total += want.numel()
        return same, total

    step_fn = make_train_step(cfg, lr=lr, mesh=mesh)
    model, state = fresh()
    first = next(model.parameters())
    say(f"-- 21f: phase 19h's step ({cfg.name} full width, {cfg.n_layers} of its 60 layers, "
        f"bf16, batch {TRAIN_MLA_BATCH} x {TRAIN_MLA_SEQ}) with the "
        f"{sum(1 for _ in model.parameters())} parameters as DTensors ({type(first).__name__}, "
        f"placements {first.placements}), AdamW's moments on their placements; the MoE "
        f"routes each device's tokens")

    # eager steps; the path's run starts here
    b7.launches = b7_bwd.launches = pack.launches = pack_ops.on_shards = 0
    b4.launches = b5.launches = 0
    eager_loss, eager_gnorm, eager_ms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    with CommDebugMode() as comm:
        for i in range(TRAIN_EAGER):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = step_fn(model, state, shard_batch(batches[i], mesh, "cuda"))[2]
            eager_loss.append(float(m["loss"]))
            eager_ms.append((time.perf_counter() - t) * 1e3)
            eager_gnorm.append(float(m["grad_norm"]))
            del m
    eager_peak = torch.cuda.max_memory_allocated()
    eager = counts()
    same, total = same_params(model)
    say(f"  eager steps: loss {eager_loss} (19h {ref['loss']}), grad norm {eager_gnorm} (19h "
        f"{ref['gnorm']}); parameters {same} of {total} bit-identical to 19h's; ms "
        f"{[round(x, 3) for x in eager_ms]}; peak memory {eager_peak / 2**30:.2f} GiB; B7 "
        f"forward, backward calls {eager[:2]} (19h {ref['b7']}); B2 launches {eager[2]} (19h "
        f"{ref['b2']}), calls through local_map {eager[5]}; B4 kernels {eager[3]} (19h "
        f"{ref['b4']}); B5 kernels {eager[4]} (19h {ref['b5']}); collectives "
        f"{comm.get_total_counts()}")
    if (eager_loss, eager_gnorm) != (ref["loss"], ref["gnorm"]) or same != total:
        fail("the sharded DeepSeek-V2 eager steps differ from 19h's bit for bit")
    if (eager[:2], eager[2], eager[3], eager[4]) != (ref["b7"], ref["b2"], ref["b4"], ref["b5"]):
        fail(f"the sharded eager steps launched B7 {eager[:2]}, B2 {eager[2]}, B4 {eager[3]}, "
             f"B5 {eager[4]}; 19h {ref['b7']}, {ref['b2']}, {ref['b4']}, {ref['b5']}")
    # each call through local_map launches its product and, in the
    # backward, the two products of its gradient
    if eager[5] != 3 * cfg.n_layers * TRAIN_EAGER or eager[2] != 3 * eager[5]:
        fail(f"B2 ran {eager[5]} calls through local_map for {eager[2]} launches, not "
             f"{3 * cfg.n_layers} calls a step, 3 launches a call")
    if comm.get_total_counts():
        fail(f"a (1, 1) mesh ran collectives: {dict(comm.get_comm_counts())}")
    del model, state
    gc.collect()
    torch.cuda.empty_cache()

    # sealed, from the same state: 19h's replays bit for bit
    model, state = fresh()
    torch.cuda.reset_peak_memory_stats()
    with CommDebugMode() as comm:
        sealed = seal_train_step(step_fn, model, state, batches[0])
    seal_peak = torch.cuda.max_memory_allocated()
    seal = tuple(c1 - c0 for c1, c0 in zip(counts(), eager))
    losses, gnorms, replay_ms = [], [], []
    for i in range(TRAIN_EAGER):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = sealed(batches[i])
        losses.append(float(m["loss"]))
        replay_ms.append((time.perf_counter() - t) * 1e3)
        gnorms.append(float(m["grad_norm"]))
    same, total = same_params(model)
    dev_ms = time_ms(sealed.graph.replay, 3, warmup=1)
    say(f"  sealed as one CUDA graph in {sealed.seal_s:.2f}s (peak memory "
        f"{seal_peak / 2**30:.2f} GiB; B2 launches by the seal {seal[2]}, calls through "
        f"local_map {seal[5]}; collectives {comm.get_total_counts()}); {TRAIN_EAGER} replays: loss "
        f"{losses}, grad norm {gnorms}; parameters {same} of {total} bit-identical to 19h's "
        f"after as many replays")
    if (losses, gnorms) != (ref["loss"], ref["gnorm"]) or same != total:
        fail("the sharded DeepSeek-V2 replays differ from 19h's bit for bit")
    if seal[5] != 2 * 3 * cfg.n_layers or seal[2] != 3 * seal[5] or comm.get_total_counts():
        fail(f"the seal ran B2 {seal[5]} calls through local_map for {seal[2]} launches (want "
             f"the warm-up's and the capture's {3 * cfg.n_layers} each) or collectives")
    replay_med = float(np.median(replay_ms))
    eager_med = float(np.median(eager_ms[1:]))
    say(f"  ms per step: eager {eager_med:.3f} (19h {ref['eager_ms']:.3f}: DTensor's host "
        f"dispatch adds {eager_med - ref['eager_ms']:.3f}), sealed replay {replay_med:.3f} "
        f"(host clock, batch copied in; 19h {ref['replay_ms']:.3f}); one replay on CUDA events "
        f"{dev_ms:.3f} (19h {ref['replay_device_ms']:.3f}); {nvidia_smi()}")
    del sealed, model, state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(b2_launches=pack.launches, on_shards=pack_ops.on_shards,
                b7_launches=b7.launches + b7_bwd.launches, eager_ms=eager_med,
                replay_ms=replay_med, replay_device_ms=dev_ms,
                unsharded_replay_device_ms=ref["replay_device_ms"],
                eager_peak_gib=eager_peak / 2**30, seal_peak_gib=seal_peak / 2**30)


# 21c: the band the dry run's predicted peak of 19c's step must fall in, as
# a share of the peak 19c measured (PERF.md gives what lies in the gap)
MEMORY_BAND = (0.90, 1.10)


def memory_count(ref: dict) -> dict:
    """21c: the dry run's counter (``launch.dryrun.partitioned`` on a fake
    (1, 1) mesh, meta tensors, nothing on the card) at phase 19c's step:
    phi4-mini-3.8b at full width and depth, bf16, AdamW, batch
    ``TRAIN_BATCH`` x ``TRAIN_SEQ``, the config's own ``remat``.  Its
    predicted peak (argument + temp + output bytes) against 19c's measured
    eager ``max_memory_allocated``, less what the earlier phases left
    allocated: the ratio must lie in :data:`MEMORY_BAND`."""
    import repro_torch.configs as C
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(C.get("phi4-mini-3.8b"), dtype="bfloat16")
    shape = InputShape(f"train_{TRAIN_BATCH}x{TRAIN_SEQ}", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    r = dryrun.partitioned(cfg, shape, (1, 1), ("data", "model"), remat=False)
    case = dryrun.build_case(cfg, shape, remat=False)
    args = sum(t.numel() * t.element_size() for leaves in case.leaves.values()
               for _, t, _ in leaves)
    predicted = args + r["temp_bytes"] + r["output_bytes"]
    measured = ref["eager_peak"] - ref["base"]
    ratio = predicted / measured
    say(f"-- 21c: the dry run's memory count at 19c's step ({cfg.name}, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, remat {cfg.remat}, a fake (1, 1) mesh, depths "
        f"{r['partitioned_layers']} extrapolated to {cfg.n_layers}, "
        f"{time.perf_counter() - t0:.1f}s on the host): argument {args / 2**30:.3f} GiB + temp "
        f"{r['temp_bytes'] / 2**30:.3f} GiB + output {r['output_bytes']} B = predicted peak "
        f"{predicted / 2**30:.3f} GiB; 19c measured an eager peak of "
        f"{ref['eager_peak'] / 2**30:.3f} GiB less {ref['base'] / 2**30:.3f} GiB left by the "
        f"phases before = {measured / 2**30:.3f} GiB; predicted / measured {ratio:.4f} (band "
        f"{MEMORY_BAND[0]}-{MEMORY_BAND[1]}); bytes accessed per step "
        f"{r['bytes_accessed'] / 2**30:.3f} GiB; {nvidia_smi()}")
    if not MEMORY_BAND[0] <= ratio <= MEMORY_BAND[1]:
        fail(f"the dry run's predicted peak {predicted} B is {ratio:.4f} of 19c's {measured} B, "
             f"outside {MEMORY_BAND}")
    return dict(predicted=predicted, measured=measured, ratio=ratio, args=args,
                temp=r["temp_bytes"], output=r["output_bytes"], accessed=r["bytes_accessed"])


def _local_cpu(model) -> list:
    return [(p.to_local() if hasattr(p, "to_local") else p).detach().cpu()
            for p in model.parameters()]


def sharded_recurrent_train(mesh) -> dict:
    """21d: xlstm-125m at full width and depth, bf16, AdamW at a fixed lr
    on ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens: ``TRAIN_EAGER`` eager steps
    and as many replays of the sealed step, unsharded and then with the
    parameters, AdamW state and batch as DTensors on ``mesh`` (the mLSTM's
    chunked form and the sLSTM on local shards): losses, grad norms and
    parameters bit for bit."""
    import gc

    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    import repro_torch.configs as C
    from repro_torch.data import SyntheticLM, data_config_for, shard_batch
    from repro_torch.distributed import shard_model
    from repro_torch.kernels.adamw import kernel as b4
    from repro_torch.launch import serve
    from repro_torch.models import param_axes
    from repro_torch.optim import adamw_init
    from repro_torch.training import make_train_step, seal_train_step
    from repro_torch.training.train_lib import batch_to_device

    release()
    cfg = dataclasses.replace(C.get("xlstm-125m"), dtype="bfloat16")
    data = SyntheticLM(data_config_for(cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ))
    batches = [data.batch(i) for i in range(TRAIN_EAGER)]

    def run(on):
        def fresh():
            model = serve.init_params(cfg, seed=0, device="cuda")
            if on is not None:
                shard_model(model, param_axes(cfg), on)
            return model, adamw_init(dict(model.named_parameters()))

        step_fn = make_train_step(cfg, lr=TRAIN_LR, mesh=on)
        model, state = fresh()
        leaves = len(list(model.parameters()))
        b4_start = b4.launches
        eager, ms = [], []
        with CommDebugMode() as comm:
            for b in batches:
                placed = batch_to_device(b, "cuda") if on is None else shard_batch(b, on, "cuda")
                torch.cuda.synchronize()
                t = time.perf_counter()
                m = step_fn(model, state, placed)[2]
                eager.append((float(m["loss"]), float(m["grad_norm"])))
                ms.append((time.perf_counter() - t) * 1e3)
        eager_params = _local_cpu(model)
        del model, state, m
        gc.collect()
        torch.cuda.empty_cache()
        model, state = fresh()
        sealed = seal_train_step(step_fn, model, state, batches[0])
        replays = []
        for b in batches:
            m = sealed(b)
            replays.append((float(m["loss"]), float(m["grad_norm"])))
        replay_params = _local_cpu(model)        # before the timed replays move them
        out = dict(eager=eager, eager_params=eager_params, replays=replays,
                   b4=(b4.launches - b4_start, (TRAIN_EAGER + 1) * (2 * leaves + 1)),
                   replay_params=replay_params, eager_ms=ms, seal_s=sealed.seal_s,
                   replay_ms=time_ms(sealed.graph.replay, 3, warmup=1),
                   collectives=comm.get_total_counts(),
                   placement=str(next(model.parameters()).placements) if on is not None else "")
        del sealed, model, state
        gc.collect()
        torch.cuda.empty_cache()
        return out

    want, got = run(None), run(mesh)

    def same(a, b):
        return sum(int(torch.equal(x, y)) for x, y in zip(a, b))

    n = len(want["eager_params"])
    eq_eager, eq_replay = same(got["eager_params"], want["eager_params"]), same(
        got["replay_params"], want["replay_params"])
    say(f"-- 21d: {cfg.name}, full width, {cfg.n_layers} layers (sLSTM at "
        f"{cfg.xlstm.slstm_at}), bf16, batch {TRAIN_BATCH} x {TRAIN_SEQ}, AdamW lr {TRAIN_LR}: "
        f"{TRAIN_EAGER} eager steps and {TRAIN_EAGER} sealed replays, unsharded and with DTensor "
        f"parameters ({got['placement']})")
    say(f"  eager (loss, grad norm): sharded {got['eager']}, unsharded {want['eager']}; "
        f"parameters {eq_eager} of {n} leaves bit-identical; ms sharded "
        f"{[round(x, 1) for x in got['eager_ms']]}, unsharded "
        f"{[round(x, 1) for x in want['eager_ms']]}; collectives {got['collectives']}")
    say(f"  replays: sharded {got['replays']}, unsharded {want['replays']} (the same as the "
        f"unsharded eager steps: {want['replays'] == want['eager']}); parameters "
        f"{eq_replay} of {n} leaves bit-identical; sealed in {got['seal_s']:.2f}s "
        f"(unsharded {want['seal_s']:.2f}s); one replay {got['replay_ms']:.3f} ms on CUDA events "
        f"(unsharded {want['replay_ms']:.3f})")
    if (got["eager"], got["replays"]) != (want["eager"], want["replays"]) or (
            eq_eager, eq_replay) != (n, n):
        fail("xlstm-125m's sharded train steps differ from the unsharded ones bit for bit")
    if got["collectives"]:
        fail(f"a (1, 1) mesh ran collectives: {got['collectives']}")
    say(f"  B4 kernels (launched, want: {TRAIN_EAGER} eager steps and the seal's capture): "
        f"sharded {got['b4']}, unsharded {want['b4']}")
    if got["b4"][0] != got["b4"][1] or want["b4"][0] != want["b4"][1]:
        fail("xlstm-125m's train steps did not run B4 as often as their leaves want")
    return dict(losses=[x[0] for x in got["eager"]], eager_ms=got["eager_ms"],
                replay_ms=got["replay_ms"], unsharded_replay_ms=want["replay_ms"])


def sharded_hybrid_forward(mesh) -> dict:
    """21e: zamba2-2.7b at full width and depth, bf16: one forward of
    ``DECODE_BATCH`` x ``FORWARD_LEN`` tokens, then the same with the
    parameters and batch as DTensors on ``mesh`` (Mamba2's conv and SSD
    scan on local shards): logits bit for bit, B1 launched once per shared
    attention block, every call through ``local_map``."""
    import torch

    import repro_torch.configs as C
    from repro_torch.distributed import batch_axes, shard_model, shard_tree, use_sharding_ctx
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.launch import serve
    from repro_torch.models import forward, param_axes

    release()
    cfg = dataclasses.replace(C.get("zamba2-2.7b"), dtype="bfloat16")
    model = serve.init_params(cfg, seed=0, device="cuda")
    batch = {"tokens": _tokens(cfg, DECODE_BATCH, FORWARD_LEN, seed=22)}
    apps = cfg.n_layers // cfg.hybrid_attn_every
    with torch.no_grad():
        want = forward(model, batch, cfg)[0]
        torch.cuda.synchronize()
        shard_model(model, param_axes(cfg), mesh)
        placed = shard_tree(batch, batch_axes(batch), mesh)
        kernel.launches = ops.on_shards = 0             # the path's run starts here
        with use_sharding_ctx(mesh):
            t = time.perf_counter()
            got = forward(model, placed, cfg)[0]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
    launches, on_shards = kernel.launches, ops.on_shards
    same = bool(torch.equal(got.to_local(), want))
    say(f"-- 21e: {cfg.name}, full width, {cfg.n_layers} layers, bf16, a forward of "
        f"{DECODE_BATCH} x {FORWARD_LEN} tokens with DTensor parameters: logits "
        f"{tuple(got.shape)} bit-identical to the unsharded forward's: {same}; B1 launches "
        f"{launches}, through local_map {on_shards} (want {apps}); {ms:.3f} ms (host clock, "
        f"first call)")
    if not same or launches != apps or on_shards != launches:
        fail("zamba2-2.7b's sharded forward differs from the unsharded one or missed B1")
    del model, want, got
    return dict(launches=launches, on_shards=on_shards, forward_ms=ms)


@contextlib.contextmanager
def one_card_mesh():
    """A (1, 1) ``("data", "model")`` mesh over a process group of one
    (NCCL, rank 0 of 1), destroyed on exit."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        yield make_host_mesh(model_axis=1, device="cuda")
    finally:
        dist.destroy_process_group()


def phase_sharded(number: int, reference: dict, deepseek_ref: dict) -> dict:
    """Phase 21: sharded execution on the card over a process group of one
    (NCCL, rank 0 of 1) and a (1, 1) mesh, where every placement is
    Replicate: the DTensor path, ``local_map`` and the sealed step run the
    kernels on the card (21a, 21b, 21f, 21d, 21e); between them, 21c holds
    the dry run's memory count (a fake process group of its own) against
    19c's measured peak.  Collectives across cards are checked on the CPU
    (gloo) only: NCCL refuses two ranks on one card."""
    say(f"== phase {number}: sharded execution on one card (NCCL, world 1, a (1, 1) mesh)")
    with one_card_mesh() as mesh:
        with train_path("sharded train phi4-mini-3.8b on a (1, 1) mesh (eager steps, seal)"):
            train = sharded_train(mesh, reference)
        with b7_path("sharded forward deepseek-v2-236b on a (1, 1) mesh (21b)"):
            fwd = sharded_forward(mesh)
        with train_path("sharded train deepseek-v2-236b on a (1, 1) mesh (21f)"), \
                b7_path("sharded train deepseek-v2-236b on a (1, 1) mesh (21f)"), \
                b2_path("sharded train deepseek-v2-236b on a (1, 1) mesh (21f)"):
            deepseek = sharded_train_deepseek(mesh, deepseek_ref)
        del deepseek_ref
    memory = memory_count(reference)
    with one_card_mesh() as mesh:
        with train_path("train xlstm-125m unsharded and on a (1, 1) mesh"):
            recurrent = sharded_recurrent_train(mesh)
        hybrid = sharded_hybrid_forward(mesh)
    release()
    return dict(train=train, forward=fwd, deepseek=deepseek, memory=memory,
                recurrent=recurrent, hybrid=hybrid)


# ---------------------------------------------------------------------------
# phase 22: long_500k on the card
# ---------------------------------------------------------------------------

# long_500k: batch 1 over a cache of 524288 positions, the steps timed, and
# pos at the start of the steps (the steps write the 16 positions after it)
LONG_T, LONG_STEPS = 524288, 16
LONG_POS = LONG_T - 17
# 22a: the shapes (label, arch, deferred form, window), the splits into
# shards (3: uneven) and the offsets: kv_valid inside a shard, on the
# boundary of the first shard of 2 (of 4 and 8 too) and of 3 shards, and so
# early that whole shards lie past it (and, under the window, before its
# reach)
LONG_SHAPES = [("zamba2-2.7b cache form", "zamba2-2.7b", False, None),
               ("gemma2-27b global layer, deferred, cap 50", "gemma2-27b", True, 2**30),
               ("gemma2-27b local layer, window 4096, cap 50", "gemma2-27b", True, 4096)]
LONG_SPLITS = (1, 2, 3, 4, 8)
LONG_LSE_ATOL = 1e-3
# 22b': gemma2-27b's depth on the card, one local and one global layer
LONG_GEMMA_LAYERS = 2


def long_bounds(T: int, P: int) -> list[int]:
    """The first position of each of ``P`` shards of ``T`` and the end, as
    ``torch.tensor_split`` cuts (uneven when ``P`` does not divide ``T``)."""
    return [i * (T // P) + min(i, T % P) for i in range(P + 1)]


def long_inputs(arch: str, new: bool, seed: int):
    """q (1, 1, NH, hd), the cache (1, LONG_T, NKV, hd) as views of one
    (2, 1, LONG_T, NKV, hd) tensor, the step's own keys (the deferred form)
    and the call's keywords for ``arch``'s heads, bf16 on the card."""
    import torch

    import repro_torch.configs as C

    cfg = C.get(arch)
    NH, NKV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((1, 1, NH, hd), generator=g, device="cuda").to(torch.bfloat16)
    if cfg.attn_softcap:
        q = q * CAP_Q_SCALE
    kv = torch.empty((2, 1, LONG_T, NKV, hd), dtype=torch.bfloat16, device="cuda")
    kv.normal_(generator=g)
    kn = vn = None
    if new:
        kn, vn = torch.randn((2, 1, 1, NKV, hd), generator=g, device="cuda").to(torch.bfloat16)
    kw = dict(scale=cfg.attn_logit_scale or 1.0 / math.sqrt(hd), softcap=cfg.attn_softcap)
    return q, kv[0], kv[1], kn, vn, kw


def long_offsets(new: bool, kvv: int) -> dict:
    """positions and kv_valid (0-d, on the card) for a step whose cache
    holds ``kvv`` valid positions: the deferred form's query sits at kvv,
    the cache form's at kvv - 1 (its own key already written)."""
    import torch

    pos = kvv if new else kvv - 1
    return dict(positions=torch.tensor([pos], device="cuda"),
                kv_valid=torch.tensor(kvv, device="cuda"))


def long_split(q, kc, vc, kn, vn, kw, P: int):
    """B3's partials over ``P`` shards of the cache (strided views, each
    with its ``t_start``, the step's own keys on the first) and their plain
    versions: the kernel's and the plain (out, lse) stacked, and each
    shard's positions."""
    import torch

    from repro_torch.kernels.decode_attention import (decode_attention_partials,
                                                      decode_attention_partials_ref)

    b = long_bounds(kc.shape[1], P)
    got, ref, count = [], [], []
    for i in range(P):
        new = (kn, vn) if i == 0 else (None, None)
        args = (q, kc[:, b[i]:b[i + 1]], vc[:, b[i]:b[i + 1]], *new)
        got.append(decode_attention_partials(*args, t_start=b[i], **kw))
        ref.append(decode_attention_partials_ref(*args, t_start=b[i], **kw))
        count.append(b[i + 1] - b[i] + (0 if kn is None or i else kn.shape[1]))
    stack = [tuple(torch.stack(x) for x in zip(*parts)) for parts in (got, ref)]
    return stack[0], stack[1], torch.tensor(count, dtype=torch.float32, device="cuda")


def long_partials() -> dict:
    """22a: B3's partials form at long_500k's shapes, each split of the
    cache into shards combined over their stack, against the plain
    partials shard by shard and, combined, against the plain version and
    the whole-cache B3; then timed."""
    import torch

    from repro_torch.kernels.decode_attention import (combine, decode_attention,
                                                      decode_attention_ref, over_stack)
    from repro_torch.kernels.decode_attention import ref as b3_ref

    say(f"-- 22a: B3's partials form over a cache of {LONG_T} positions (bf16), split into "
        f"{LONG_SPLITS} shards (strided views, 3 uneven), each shard's (out, lse) against its "
        f"plain version (out at B3's tolerance, lse within {LONG_LSE_ATOL:g}; a shard that "
        "sees no key: the kernel's 0 and -inf), the shards combined (ops.combine over their "
        "stack) against the plain version and the whole-cache B3 on the whole cache")
    worst, failed, cases = 0.0, [], 0
    for n, (label, arch, new, window) in enumerate(LONG_SHAPES):
        q, kc, vc, kn, vn, kw = long_inputs(arch, new, seed=2200 + n)
        kw["window"] = window
        for kvv in (LONG_POS + 1, long_bounds(LONG_T, 2)[1], long_bounds(LONG_T, 3)[1],
                    LONG_T // 8 + 5):
            kw.update(long_offsets(new, kvv))
            whole = decode_attention(q, kc, vc, kn, vn, **kw)
            plain = decode_attention_ref(q, kc, vc, kn, vn, **kw)
            r_whole = decode_ratio(whole, plain, "bfloat16")
            for P in LONG_SPLITS:
                (out, lse), (pout, plse), count = long_split(q, kc, vc, kn, vn, kw, P)
                seen = plse > b3_ref.NEG_INF / 2
                empty_ok = bool((lse[~seen] == -math.inf).all() and (out[~seen] == 0).all())
                lse_err = (lse[seen] - plse[seen]).abs().max().item() if seen.any() else 0.0
                r_out = decode_ratio(torch.where(seen[..., None], out, pout), pout, "bfloat16")
                got = combine(out, lse, count.reshape(-1, 1, 1, 1), over_stack,
                              dtype=q.dtype)[0]
                r_plain = decode_ratio(got, plain, "bfloat16")
                r_kernel = decode_ratio(got, whole, "bfloat16")
                same = torch.equal(got, whole)
                ok = (empty_ok and lse_err <= LONG_LSE_ATOL and max(r_out, r_plain, r_kernel)
                      <= 1.0)
                cases += 1
                worst = max(worst, r_out, r_plain, r_kernel)
                say(f"  {label}: kv_valid {kvv}, {P} shards ({int(seen[:, 0, 0, 0].sum())} "
                    f"with a visible key): shards {r_out:.2f} of tolerance, lse err "
                    f"{lse_err:.2e}, empty shards {'0/-inf' if empty_ok else 'WRONG'}; "
                    f"combined {r_plain:.2f} of tolerance against plain, {r_kernel:.2f} "
                    f"against the whole B3 ({'bit-identical' if same else 'not bit-identical'}; "
                    f"whole B3 {r_whole:.2f} against plain) {'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"{label} kv_valid {kvv} P {P}")
                del out, lse, pout, plse, got
            del whole, plain
        del q, kc, vc, kn, vn
        torch.cuda.empty_cache()
    if failed:
        fail(f"B3's partials disagree at {failed}")
    say(f"  {cases} splits within tolerance (worst at {worst:.2f} of it)")
    record = long_partials_time()
    record.update(cases=cases, worst_of_tolerance=worst)
    return record


def long_partials_time() -> dict:
    """22a's times at zamba2-2.7b's shape, kv_valid near the end, in a CUDA
    graph: the whole-cache B3, the partials of 1, 2 and 8 shards plus the
    combine, the plain version, ``F.scaled_dot_product_attention`` with a
    boolean mask (a yardstick), beside the bound: the cache's K and V once
    (5.37 GB)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.decode_attention import (combine, decode_attention,
                                                      decode_attention_partials,
                                                      decode_attention_ref, over_stack)
    from repro_torch.kernels.decode_attention import kernel as decode

    label, arch, new, window = LONG_SHAPES[0]
    q, kc, vc, kn, vn, kw = long_inputs(arch, new, seed=2299)
    kw.update(long_offsets(new, LONG_POS + 1), window=window)
    NH, NKV, hd = q.shape[2], kc.shape[2], q.shape[3]

    def split(P):
        b = long_bounds(LONG_T, P)
        count = torch.tensor([b[i + 1] - b[i] for i in range(P)], dtype=torch.float32,
                             device="cuda").reshape(-1, 1, 1, 1)

        def run():
            parts = [decode_attention_partials(q, kc[:, b[i]:b[i + 1]], vc[:, b[i]:b[i + 1]],
                                               t_start=b[i], **kw) for i in range(P)]
            out, lse = (torch.stack(x) for x in zip(*parts))
            return combine(out, lse, count, over_stack, dtype=q.dtype)[0]

        return run

    q4, k4, v4 = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    mask = (torch.arange(LONG_T, device="cuda") < kw["kv_valid"])[None, None, None]

    def library():
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION]):
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True,
                                                  scale=kw["scale"])

    before, before_p = decode.launches, decode.partials_launches
    calls = {"whole": lambda: decode_attention(q, kc, vc, **kw), "partials_1": split(1),
             "partials_2": split(2), "partials_8": split(8),
             "plain": lambda: decode_attention_ref(q, kc, vc, **kw), "library": library}
    want = calls["plain"]()
    errs = {name: (fn().float() - want.float()).abs().max().item()
            for name, fn in calls.items() if name != "plain"}
    ms = {name: graph_ms(fn, reps=2, iters=5) for name, fn in calls.items()}
    decode.launches, decode.partials_launches = before, before_p   # not a path's
    visible = int(kw["kv_valid"])
    nbytes = 2 * visible * NKV * hd * 2 + 2 * q.numel() * 2 + 16
    bound_ms, bound_by = bound(4.0 * hd * NH * visible, nbytes, "bfloat16")
    say(f"-- 22a timing, {label}: q (1,1,{NH},{hd}) over {visible} visible positions of "
        f"{NKV} kv heads | graph whole_ms {ms['whole']:.5f} partials_ms (1 shard + combine) "
        f"{ms['partials_1']:.5f}, (2) {ms['partials_2']:.5f}, (8) {ms['partials_8']:.5f} | "
        f"plain_ms {ms['plain']:.5f} library_ms {ms['library']:.5f} | bound_ms "
        f"{bound_ms:.5f} ({bound_by}, {nbytes / 1e9:.3f} GB) | whole at "
        f"{bound_ms / ms['whole']:.1%}, 1 shard + combine at {bound_ms / ms['partials_1']:.1%} "
        f"of the bound | max_abs_err against plain {errs}")
    del q, kc, vc, want
    torch.cuda.empty_cache()
    return dict(shape=[1, LONG_T, 1, NH, NKV, hd], ms=ms["partials_1"], whole_ms=ms["whole"],
                split_ms={P: ms[f"partials_{P}"] for P in (1, 2, 8)}, plain_ms=ms["plain"],
                library_ms=ms["library"], bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes, max_abs_err=errs["partials_1"])


def long_model(arch: str, layers: int | None):
    """``arch`` at full width (``layers`` of its depth, or all), bf16,
    random weights drawn on the card from seed 0."""
    import torch

    import repro_torch.configs as C
    from repro_torch.launch import serve

    release()
    cfg = dataclasses.replace(C.get(arch), dtype="bfloat16")
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = serve.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    return cfg, model


def long_decode(arch: str, layers: int | None, mesh) -> dict:
    """22b / 22b': ``arch`` at full width, bf16, batch 1, a cache of
    ``LONG_T`` positions (``init_cache(per_slot=False)``: long_500k's
    synchronized cache) filled from a seeded generator, the recurrent state
    too, pos at ``LONG_POS``: ``LONG_STEPS`` greedy steps eagerly and as
    replays of one captured step; then the same storage wrapped as
    DTensors on ``mesh`` (the attention cache ``Shard`` over its positions,
    the rest replicated, the parameters through ``shard_model``) under the
    long-context rules, so that attention takes the partials path: the
    same again.  The sharded tokens must equal the unsharded ones and the
    logits lie within B3's tolerance of them; each replay runs one B3
    kernel an attention layer.  Between runs only the positions the steps
    write, the recurrent state and pos are restored."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distributed import LONG_CONTEXT_OVERRIDES, shard_model, use_sharding_ctx
    from repro_torch.kernels.decode_attention import kernel as decode
    from repro_torch.models import decode_step, init_cache, param_axes
    from repro_torch.models.transformer import _window_schedule

    cfg, model = long_model(arch, layers)
    torch.cuda.reset_peak_memory_stats()
    cache = init_cache(cfg, 1, LONG_T, per_slot=False, device="cuda")
    kv_names = ("attn_k", "attn_v") if cfg.family == "hybrid" else ("k", "v")
    g = torch.Generator(device="cuda").manual_seed(22)
    for name, t in cache.items():
        if name != "pos":
            t.normal_(generator=g)            # in place, a layer's worth at a time is no temp
    cache["pos"].fill_(LONG_POS)
    attn = (cfg.n_layers // cfg.hybrid_attn_every if cfg.family == "hybrid"
            else cfg.n_layers)
    cache_gb = sum(cache[n].numel() * cache[n].element_size() for n in kv_names) / 1e9
    weights_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    # the K and V a step reads: every valid position, or a local layer's window
    visible = sum(LONG_POS + 1 if w is None else min(LONG_POS + 1, w)
                  for w in (_window_schedule(cfg) or [None] * attn))
    read_gb = cache_gb * visible / (attn * LONG_T)
    written = slice(LONG_POS, LONG_POS + LONG_STEPS)
    saved = {n: (cache[n][:, :, written].clone() if n in kv_names else cache[n].clone())
             for n in cache if n != "pos"}

    def restore():
        for n, s in saved.items():
            (cache[n][:, :, written] if n in kv_names else cache[n]).copy_(s)
        cache["pos"].fill_(LONG_POS)

    first = _tokens(cfg, 1, 1, seed=23)
    label = f"{cfg.name}, full width, {cfg.n_layers} layers"
    say(f"-- {label}: bf16, batch 1, cache of {LONG_T} positions ({attn} attention layers, "
        f"{cache_gb:.2f} GB of K and V), {weights_gb:.2f} GB of weights, pos 0-d at {LONG_POS}")

    def run(state, tokens_in, ctx):
        """Eager steps, then replays of one captured step: their tokens
        (which must agree), logits, times and B3 launches."""
        def step(tok):
            with ctx():
                logits, _ = decode_step(model, state, tok, cfg)
            logits = logits.to_local() if isinstance(logits, DTensor) else logits
            return logits[:, -1, : cfg.vocab].float(), torch.argmax(logits[:, -1, : cfg.vocab],
                                                                     dim=-1)

        def feed(tok):
            return tokens_in(tok[:, None])

        before, before_p = decode.launches, decode.partials_launches
        restore()
        tok, eager, logits = feed(first[:, 0]), [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LONG_STEPS):
            lg, nxt = step(tok)
            eager.append(nxt)
            logits.append(lg)
            tok = feed(nxt)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / LONG_STEPS * 1e3
        restore()
        tok_in = feed(first[:, 0])
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(tok_in)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        restore()
        graph = torch.cuda.CUDAGraph()
        with capture(graph):
            _, out = step(tok_in)
        got = []
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LONG_STEPS):
            graph.replay()
            got.append(out.clone())
            local = tok_in.to_local() if isinstance(tok_in, DTensor) else tok_in
            local.copy_(out[:, None])
        stop.record()
        stop.synchronize()
        replay_ms = start.elapsed_time(stop) / LONG_STEPS
        launches = (decode.launches - before, decode.partials_launches - before_p)
        eager, got = torch.stack(eager, 1).cpu(), torch.stack(got, 1).cpu()
        if not torch.equal(eager, got):
            fail(f"{label}: the captured step gives other tokens than the eager one: "
                 f"{eager.tolist()} against {got.tolist()}")

        def replay():
            restore()
            local = tok_in.to_local() if isinstance(tok_in, DTensor) else tok_in
            local.copy_(first)
            graph.replay()
            return out

        rows = by_kernel(kernels_in_one(replay))
        b3 = check_b3_replay(rows, attn, f"{label} replay")
        del graph
        return dict(tokens=eager, logits=torch.stack(logits), eager_ms=eager_ms,
                    replay_ms=replay_ms, launches=launches, b3_in_replay=b3)

    with torch.no_grad():
        with b3_path(f"long_500k {cfg.name} unsharded"):
            plain = run(cache, lambda t: t.clone(), contextlib.nullcontext)
        if plain["launches"][1]:
            fail(f"{label}: the unsharded steps launched B3's partials form")
        # the same storage as DTensors: attention's cache over its positions
        whole = [Replicate()] * mesh.ndim
        seq = [Shard(2)] + [Replicate()] * (mesh.ndim - 1)
        placed = {n: DTensor.from_local(t, mesh, seq if n in kv_names else whole,
                                        run_check=False) for n, t in cache.items()}
        if any(placed[n].to_local().data_ptr() != cache[n].data_ptr() for n in cache):
            fail(f"{label}: wrapping the cache as DTensors copied it")
        shard_model(model, param_axes(cfg), mesh)
        rules = dict(LONG_CONTEXT_OVERRIDES)
        with b3_path(f"long_500k {cfg.name} sharded over positions (partials)"):
            sharded = run(placed, lambda t: DTensor.from_local(t.clone(), mesh, whole,
                                                               run_check=False),
                          lambda: use_sharding_ctx(mesh, rules))
    B3_PARTIALS_BY_PATH[f"long_500k {cfg.name} sharded over positions"] = sharded["launches"][1]
    peak = torch.cuda.max_memory_allocated() / 2**30
    same_tokens = torch.equal(plain["tokens"], sharded["tokens"])
    same_logits = torch.equal(plain["logits"], sharded["logits"])
    r = decode_ratio(sharded["logits"], plain["logits"], "bfloat16")
    bound_ms, _ = bound(0.0, read_gb * 1e9 + weights_gb * 1e9, "bfloat16")
    say(f"  unsharded: eager {plain['eager_ms']:.3f} ms a step (host clock), replay "
        f"{plain['replay_ms']:.3f} ms a step (CUDA events); B3 launches {plain['launches'][0]}")
    say(f"  sharded over positions ({mesh.ndim}-d mesh {tuple(mesh.shape)}): eager "
        f"{sharded['eager_ms']:.3f} ms a step, replay {sharded['replay_ms']:.3f} ms a step; B3 "
        f"launches {sharded['launches'][0]}, of them partials {sharded['launches'][1]}")
    say(f"  bytes bound of a step: {bound_ms:.3f} ms ({read_gb:.2f} GB of the cache's K and V "
        f"that the step's rows see + {weights_gb:.2f} GB of weights at the card's rate); "
        f"replays at "
        f"{bound_ms / plain['replay_ms']:.1%} / {bound_ms / sharded['replay_ms']:.1%} of it; "
        f"peak memory {peak:.2f} GiB")
    say(f"  tokens unsharded {plain['tokens'].tolist()}")
    say(f"  tokens sharded   {sharded['tokens'].tolist()}")
    say(f"  sharded tokens equal: {same_tokens}; logits bit-identical: {same_logits}, "
        f"{r:.3f} of B3's tolerance")
    want = (LONG_STEPS + 2) * attn
    if not same_tokens or r > 1.0:
        fail(f"{label}: the decode sharded over positions differs from the unsharded one")
    if sharded["launches"] != (want, want) or plain["launches"][0] != want:
        fail(f"{label}: B3 launches {plain['launches']} unsharded and {sharded['launches']} "
             f"sharded (whole, partials), want {want} and ({want}, {want})")
    del model, cache, placed, saved
    return dict(arch=cfg.name, layers=cfg.n_layers, cache_gb=cache_gb, read_gb=read_gb,
                weights_gb=weights_gb,
                replay_ms=plain["replay_ms"], sharded_replay_ms=sharded["replay_ms"],
                eager_ms=plain["eager_ms"], sharded_eager_ms=sharded["eager_ms"],
                bound_ms=bound_ms, peak_gib=peak, logits_bit_identical=same_logits,
                b3_in_replay=plain["b3_in_replay"], partials_in_replay=sharded["b3_in_replay"])


# 22c: the two processes' rendezvous and result files, and their time limit
PAIR_JOIN_S = 300.0


def _long_pair_child(rank: int, tmp: str) -> None:
    """22c's process ``rank`` of 2 on the one card: a gloo group, a (2,)
    mesh over positions; zamba2-2.7b's attention application over the
    whole cache (the same seed in both), this rank's half of it wrapped as
    a ``Shard(1)`` DTensor, ``layers._decode_attention`` on it; saves the
    output, the whole-cache B3's (and on rank 0 the plain version's) and
    its launch counts."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
    from repro_torch.kernels.decode_attention import kernel as decode
    from repro_torch.models import layers

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", 2), rank=rank,
                            world_size=2)
    try:
        mesh = DeviceMesh("cuda", torch.arange(2), mesh_dim_names=("data",))
        q, kc, vc, _, _, kw = long_inputs("zamba2-2.7b", False, seed=2201)
        kw.update(long_offsets(False, LONG_POS + 1), window=None)
        with torch.no_grad():
            whole = decode_attention(q, kc, vc, **kw)
            plain = decode_attention_ref(q, kc, vc, **kw) if rank == 0 else None
            b = long_bounds(LONG_T, 2)
            halves = [t[:, b[rank]:b[rank + 1]].clone() for t in (kc, vc)]
            shape, stride = kc.shape, kc.contiguous().stride()
            del kc, vc
            torch.cuda.empty_cache()
            kd, vd = (DTensor.from_local(h, mesh, [Shard(1)], run_check=False, shape=shape,
                                         stride=stride) for h in halves)
            decode.launches = decode.partials_launches = 0
            out = layers._decode_attention(q, kd, vd, None, None, scale=kw["scale"],
                                           softcap_val=kw["softcap"],
                                           positions=kw["positions"], window=None,
                                           kv_valid=kw["kv_valid"])
            torch.cuda.synchronize()
        torch.save(dict(out=out.to_local().cpu(), whole=whole.cpu(),
                        plain=None if plain is None else plain.cpu(),
                        launches=(decode.launches, decode.partials_launches),
                        local=tuple(kd.to_local().shape)), f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def long_pair() -> dict:
    """22c: ``_long_pair_child`` in two processes on the one card over
    gloo, eager: the combine's all-reduces cross ranks on the card.  Both
    outputs equal bit for bit and within B3's tolerance of the whole-cache
    B3 and of the plain version; each rank one partials launch."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    say("-- 22c: two processes on the one card over gloo, a (2,) mesh over zamba2-2.7b's "
        f"{LONG_T} cache positions, each holding its half: layers._decode_attention, B3's "
        "partials on each half, ops.combine's max and sum all-reduced across the ranks")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_long_pair_child, args=(tmp,), nprocs=2, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + PAIR_JOIN_S
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    fail(f"22c: the two processes still run after {PAIR_JOIN_S:.0f}s")
        except mp.ProcessRaisedException as e:
            fail(f"22c: a process failed:\n{e}")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        res = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(2)]
    out, whole, plain = res[0]["out"], res[0]["whole"], res[0]["plain"]
    same = torch.equal(res[0]["out"], res[1]["out"])
    r_whole, r_plain = decode_ratio(out, whole, "bfloat16"), decode_ratio(out, plain, "bfloat16")
    err = (out.float() - plain.float()).abs().max().item()
    say(f"  local shards {[r['local'] for r in res]}; launches (B3, of them partials) "
        f"{[r['launches'] for r in res]}; the ranks' outputs equal: {same}; {r_whole:.2f} of "
        f"B3's tolerance against the whole-cache B3 ({'bit-identical' if torch.equal(out, whole) else 'not bit-identical'}), "
        f"{r_plain:.2f} against the plain version (max_abs_err {err:.3e}); "
        f"{time.perf_counter() - t0:.1f}s with the processes' start")
    if not same or max(r_whole, r_plain) > 1.0 or any(r["launches"] != (1, 1) for r in res):
        fail("22c: the two-process decode attention disagrees or missed B3's partials")
    return dict(of_tolerance=max(r_whole, r_plain), ranks_equal=same, max_abs_err=err)


def phase_long(number: int) -> dict:
    """Phase 22: long_500k on the card; see the module docstring."""
    say(f"== phase {number}: long_500k on the card (batch 1, a cache of {LONG_T} positions "
        "sharded over positions)")
    release()
    partials = long_partials()
    with one_card_mesh() as mesh:
        zamba2 = long_decode("zamba2-2.7b", None, mesh)
        release()
        gemma2 = long_decode("gemma2-27b", LONG_GEMMA_LAYERS, mesh)
    release()
    pair = long_pair()
    return dict(partials=partials, zamba2=zamba2, gemma2=gemma2, pair=pair)

# ---------------------------------------------------------------------------
# phase 23: DeepSeek-V2 at decode_32k's per-device share
# ---------------------------------------------------------------------------


def phase_latent_32k(number: int) -> dict:
    """23: deepseek-v2-236b at full width and 2 of its 60 layers, bf16,
    weights drawn from phase 9's seed, at decode_32k's per-device share:
    SYNC_BATCH sequences over a synchronized (``per_slot=False``) latent
    cache of LONG_PROMPT positions filled from a seed, ``pos`` near its
    end.  SYNC_STEPS greedy steps eagerly and as replays of one captured
    step (its logits and tokens): the same tokens and logits; ms a replay,
    its kernels with B6's and B2's shares, the peak memory.  Between runs
    the positions the steps write, and ``pos``, are restored."""
    import torch

    import repro_torch.configs as C
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, init_cache

    release()
    cfg = dataclasses.replace(C.get("deepseek-v2-236b"), n_layers=2, dtype="bfloat16")
    B, T = SYNC_BATCH, LONG_PROMPT
    t0 = time.perf_counter()
    model = serve.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    say(f"== phase {number}: deepseek-v2-236b at decode_32k's per-device share, full width, "
        f"{cfg.n_layers} of 60 layers, bf16: B = {B} (decode_32k's 128 over the 16-way data "
        f"axis), a synchronized latent cache of {T} positions, all {cfg.n_heads} heads; "
        f"weights drawn in {time.perf_counter() - t0:.1f}s")
    torch.cuda.reset_peak_memory_stats()
    cache = init_cache(cfg, B, T, per_slot=False, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(23)
    for name in ("ckv", "krope"):
        cache[name].copy_(torch.randn(cache[name].shape, generator=g, device="cuda",
                                      dtype=cache[name].dtype))
    cache_gb = sum(cache[n].numel() * cache[n].element_size() for n in ("ckv", "krope")) / 1e9
    p0 = T - 2 * SYNC_STEPS
    written = slice(p0, p0 + SYNC_STEPS)
    saved = {n: cache[n][:, :, written].clone() for n in ("ckv", "krope")}

    def restore():
        for n in ("ckv", "krope"):
            cache[n][:, :, written].copy_(saved[n])
        cache["pos"].fill_(p0)

    def step(tok):
        logits, _ = decode_step(model, cache, tok, cfg)
        logits = logits[:, -1, : cfg.vocab]
        return logits, torch.argmax(logits, dim=-1)

    first = _tokens(cfg, B, 1, seed=24)
    with torch.no_grad():
        restore()
        tok, eager = first.clone(), []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SYNC_STEPS):
            logits, nxt = step(tok)
            eager.append((logits.clone(), nxt))
            tok = nxt[:, None]
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) / SYNC_STEPS * 1e3

        restore()
        tok_in = first.clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(tok_in)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        restore()
        graph = torch.cuda.CUDAGraph()
        with capture(graph):
            out = step(tok_in)
        got = []
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(SYNC_STEPS):
            graph.replay()
            got.append((out[0].clone(), out[1].clone()))
            tok_in.copy_(out[1][:, None])
        stop.record()
        stop.synchronize()
        replay_ms = start.elapsed_time(stop) / SYNC_STEPS
    tokens = {k: torch.stack([t for _, t in run], 1).cpu() for k, run in
              (("eager", eager), ("graph", got))}
    diff = max((a - b).abs().max().item() for (a, _), (b, _) in zip(eager, got))
    same = all(torch.equal(a, b) for (a, _), (b, _) in zip(eager, got))
    say(f"  cache {cache_gb:.3f} GB of bf16 latents, pos 0-d at {p0}; {SYNC_STEPS} greedy "
        f"steps: eager {eager_ms:.3f} ms a step (host clock), graph replay {replay_ms:.3f} ms a "
        f"step (CUDA events, with the token feed)")
    say(f"  tokens eager {tokens['eager'].tolist()}")
    say(f"  tokens graph {tokens['graph'].tolist()}")
    say(f"  logits eager against graph: max |diff| {diff:.3e}, "
        f"{'equal' if same else 'NOT equal'}")
    if not torch.equal(tokens["eager"], tokens["graph"]) or not same:
        fail("the captured decode_32k step gives other tokens or logits than the eager one")
    if tokens["eager"].min() < 0 or tokens["eager"].max() >= cfg.vocab:
        fail(f"a token outside [0, {cfg.vocab})")

    def replay():
        restore()
        tok_in.copy_(first)
        graph.replay()
        return out

    rows = by_kernel(kernels_in_one(replay))
    if not rows:
        fail("the profiler saw no device time in a decode_32k replay")
    total = sum(us for us, _, _ in rows)
    b2_us = sum(us for us, _, key in rows if "stream_pack_" in key)
    peak = torch.cuda.max_memory_allocated() / 2**30
    say(f"  one replay (after the copies that restore its state): {sum(c for _, c, _ in rows)} "
        f"device ops, {total / 1e3:.3f} ms of kernels, B2 {b2_us / 1e3:.3f} ms "
        f"({b2_us / total:.1%}); peak memory {peak:.2f} GiB; top:")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        say(f"  {us / total:6.1%} {us / 1e3:8.3f} ms x{count:<4d} {key[:90]}")
    b6 = check_b6_replay(rows, cfg.n_layers, b6_kernels_per_call(cfg, B, 1, T),
                         "decode_32k replay")
    del graph, cache, saved, model
    release()
    return dict(batch=B, cache_positions=T, cache_gb=cache_gb, eager_step_ms=eager_ms,
                replay_ms=replay_ms, replay_kernels_ms=total / 1e3, b2_ms=b2_us / 1e3,
                peak_gib=peak, logits_equal=same, b6_in_replay=b6)


# B3's launches on each path (the count set to 0 just before the path and
# read just after it), and the kernels (dtype, head dim, query rows a CTA)
# the paths ran it with
B3_BY_PATH: dict[str, int] = {}
# ... and of its partials form, on the paths sharded over positions
B3_PARTIALS_BY_PATH: dict[str, int] = {}


# B6's launches on each path that serves DeepSeek-V2 (the count set to 0
# just before the path and read just after it)
B6_BY_PATH: dict[str, int] = {}


@contextlib.contextmanager
def b6_path(name: str):
    """Count B6's launches over one path into ``B6_BY_PATH[name]``."""
    from repro_torch.kernels.latent_attention import kernel as b6

    b6.launches = 0
    try:
        yield
    finally:
        B6_BY_PATH[name] = B6_BY_PATH.get(name, 0) + b6.launches


# B7's calls (forward and backward) on each path that runs MLA's expanded
# form (the counts set to 0 just before the path and read just after it)
B7_BY_PATH: dict[str, int] = {}


@contextlib.contextmanager
def b7_path(name: str):
    """Count B7's forward and backward calls over one path into
    ``B7_BY_PATH[name]``."""
    from repro_torch.kernels.expanded_attention import backward as b7_bwd
    from repro_torch.kernels.expanded_attention import kernel as b7

    b7.launches = b7_bwd.launches = 0
    try:
        yield
    finally:
        B7_BY_PATH[name] = B7_BY_PATH.get(name, 0) + b7.launches + b7_bwd.launches


@contextlib.contextmanager
def b3_path(name: str):
    """Count B3's launches over one path into ``B3_BY_PATH[name]``."""
    from repro_torch.kernels.decode_attention import kernel as decode

    decode.launches = 0
    try:
        yield
    finally:
        B3_BY_PATH[name] = B3_BY_PATH.get(name, 0) + decode.launches


# B2's launches by path and variant: {path: {variant: calls}} (b2_variants)
B2_VARIANTS: dict = {}
_B2_PATHS: list = []


@contextlib.contextmanager
def b2_variants():
    """Count every launch of B2's wrapper under the innermost ``b2_path``
    by the variant ``launch_for`` names; the calls and the wrapper's count
    are otherwise unchanged."""
    from repro_torch.kernels.stream_pack import kernel as pack

    inner = pack.stream_pack_matmul

    def recording(x, w, **kw):
        out = inner(x, w, **kw)
        if _B2_PATHS:
            by = B2_VARIANTS.setdefault(_B2_PATHS[-1], {})
            variant = pack.launch_for(x, w).variant
            by[variant] = by.get(variant, 0) + 1
        return out

    pack.stream_pack_matmul = recording
    try:
        yield
    finally:
        pack.stream_pack_matmul = inner


@contextlib.contextmanager
def b2_path(name: str):
    """Record B2's variants over one path under ``name``."""
    _B2_PATHS.append(name)
    try:
        yield
    finally:
        _B2_PATHS.pop()


@contextlib.contextmanager
def b3_instances(seen: set):
    """Add to ``seen`` the kernel (dtype, head dim, rows) of every call of
    B3 on CUDA tensors from the model layers; the calls and the wrapper's
    count are otherwise unchanged."""
    from repro_torch.kernels.decode_attention import kernel as decode
    from repro_torch.models import layers

    inner = layers.decode_attention

    def recording(q, k_cache, v_cache, k_new=None, v_new=None, **kw):
        if q.is_cuda:
            launch = decode.launch_for(q, k_cache, k_new is not None)
            seen.add((launch.dtype, launch.head_dim, launch.rows))
        return inner(q, k_cache, v_cache, k_new, v_new, **kw)

    layers.decode_attention = recording
    try:
        yield seen
    finally:
        layers.decode_attention = inner


# B4's and B5's launches on each training path (each count set to 0 just
# before the path and read just after it)
B4_BY_PATH: dict[str, int] = {}
B5_BY_PATH: dict[str, int] = {}


@contextlib.contextmanager
def train_path(name: str):
    """Count B4's and B5's launches over one training path into
    ``B4_BY_PATH[name]`` and ``B5_BY_PATH[name]``, and B8's and B9's into
    ``NORM_ROPE_BY_PATH[name]``."""
    from repro_torch.kernels.adamw import kernel as b4
    from repro_torch.kernels.cross_entropy import kernel as b5

    b4.launches = b5.launches = 0
    try:
        with norm_rope_path(name):
            yield
    finally:
        B4_BY_PATH[name] = B4_BY_PATH.get(name, 0) + b4.launches
        B5_BY_PATH[name] = B5_BY_PATH.get(name, 0) + b5.launches


# B8's and B9's calls on each path, by kernel module (rms_norm, rms_norm_bwd,
# rotary; the counts set to 0 just before the path and read just after it)
NORM_ROPE_BY_PATH: dict[str, dict[str, int]] = {}
# the paths of models with RMSNorm and RoPE: each must launch B8's forward
# and B9
NORM_ROPE_PATHS = ("serve phi4-mini-3.8b", "serve arctic-480b", "serve deepseek-v2-236b",
                   "train phi4-mini-3.8b (eager steps, seal)", "train smoke configs on the card",
                   "train deepseek-v2-236b 1 layer (eager steps, seal)",
                   "sharded train phi4-mini-3.8b on a (1, 1) mesh (eager steps, seal)",
                   "sharded train deepseek-v2-236b on a (1, 1) mesh (21f)",
                   "synchronized decode_32k and prefill_32k phi4-mini-3.8b",
                   "deepseek-v2-236b decode_32k share (phase 23)")


@contextlib.contextmanager
def norm_rope_path(name: str):
    """Count B8's forward and backward and B9's calls over one path into
    ``NORM_ROPE_BY_PATH[name]``."""
    from repro_torch.kernels.rms_norm import backward as b8_bwd
    from repro_torch.kernels.rms_norm import kernel as b8
    from repro_torch.kernels.rotary import kernel as b9

    b8.launches = b8_bwd.launches = b9.launches = 0
    try:
        yield
    finally:
        rec = NORM_ROPE_BY_PATH.setdefault(name, dict(rms_norm=0, rms_norm_bwd=0, rotary=0))
        rec["rms_norm"] += b8.launches
        rec["rms_norm_bwd"] += b8_bwd.launches
        rec["rotary"] += b9.launches


def norm_rope_records(record: dict) -> list[tuple[str, dict, str]]:
    """Phase 3e's record as the kernels line's three entries, ``(name,
    fields, note)``: B8's forward and backward apart (19h's rows beside
    each), B9."""
    def part(rec: dict, bwd: bool) -> dict:
        keys = ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by", "bytes", "launch")
        out = {k: rec[("bwd_" if bwd else "") + k] for k in keys}
        out.update(shape=rec["shape"], library_ms=rec[("bwd_" if bwd else "") + "library_ms"],
                   library=rec[("bwd_" if bwd else "") + "library"])
        if bwd:
            out.update(partial_bytes=rec["bwd_partial_bytes"], occupancy=rec["bwd_occupancy"])
        return out

    b8, b9 = record["b8"], record["b9"]
    fwd = dict(part(b8, False), deepseek_19h=part(b8["deepseek_19h"], False),
               max_abs_err=b8["max_abs_err"])
    bwd = dict(part(b8, True), deepseek_19h=part(b8["deepseek_19h"], True),
               max_abs_err=b8["max_abs_err"])
    return [("rms_norm", fwd,
             "launches count calls, one kernel each; ms, plain_ms, bound_ms and library_ms "
             "(F.rms_norm) are at 19c's rows (1024 x 3072 bf16) in a CUDA graph, 19h's "
             "(8192 x 5120) beside them"),
            ("rms_norm_bwd", bwd,
             f"launches count calls, {B8_BWD_KERNELS} kernels each (the rows, each cluster's "
             "d(scale) added through distributed shared memory into a partial row; then the "
             "partial rows summed in a fixed order); ms, plain_ms, bound_ms and library_ms "
             "(aten._fused_rms_norm_backward, bf16 weight) at 19c's rows in a CUDA graph, "
             "19h's beside them"),
            ("rotary", b9,
             "launches count calls, one kernel each, forward or backward (-sin); ms, plain_ms "
             "and bound_ms at 19c's q (2, 512, 24, 128) bf16 in a CUDA graph, 19h's q_rope "
             "beside them; PyTorch has no rotary call")]


def main() -> None:
    t_start = time.perf_counter()
    try:
        import torch  # noqa: F401
    except ImportError:
        fail("PyTorch is not installed")
    name, count = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        fail(f"repro_torch not found under {ROOT / 'src'}: run from a checkout of the repo")
    phase_build()
    record = phase_kernel()
    b3_record = phase_decode_kernel()
    b6_record = phase_latent_kernel()
    b7_record = phase_expanded_kernel()
    b8_b9_record = phase_norm_rope()
    from repro_torch.kernels.decode_attention import kernel as decode
    from repro_torch.kernels.expanded_attention import kernel as expanded
    from repro_torch.kernels.latent_attention import kernel as latent

    decode.layout_copies = latent.layout_copies = expanded.layout_copies = 0
    from repro_torch.kernels.rms_norm import kernel as b8
    from repro_torch.kernels.rotary import kernel as b9
    from repro_torch.kernels.stream_pack import kernel as pack

    b8.layout_copies = b9.layout_copies = 0

    pack.layout_copies = 0
    b3_seen: set = set()
    with b3_instances(b3_seen), b2_variants():
        with b3_path("serve phi4-mini-3.8b"), norm_rope_path("serve phi4-mini-3.8b"):
            launches, in_replays, _ = phase_serve()
        with b3_path("phi4-mini-3.8b 2 layers f32 on the card (phase 5)"), \
                norm_rope_path("phi4-mini-3.8b 2 layers f32 on the card (phase 5)"):
            phase_cpu_parity()
        pack_record = phase_stream_pack()
        with b2_path("nimble branchy cells"):
            pack_launches, pack_in_replays, pack_profiled = phase_nimble()
        with b3_path("serve arctic-480b"), b2_path("serve arctic-480b"), \
                norm_rope_path("serve arctic-480b"):
            arctic = phase_serve_moe("arctic-480b", 8)
        with b2_path("serve deepseek-v2-236b"), b6_path("serve deepseek-v2-236b"), \
                norm_rope_path("serve deepseek-v2-236b"):
            deepseek = phase_serve_moe("deepseek-v2-236b", 9)
        with b3_path("arctic-smoke f32 on the card (phase 10)"), \
                norm_rope_path("arctic-smoke, deepseek-v2-smoke f32 on the card (phase 10)"):
            phase_moe_cpu_parity(10)
        seen: set = set()
        with b1_calls(seen):
            with b3_path("serve llava-next-34b"), norm_rope_path("llava-next-34b serve, forward"):
                vlm = phase_vlm(11)
            with b3_path("seamless-m4t-medium decode"):
                audio = phase_audio(12)
            with b3_path("zamba2-2.7b decode"), norm_rope_path("zamba2-2.7b forward, decode"):
                hybrid = phase_recurrent("zamba2-2.7b", 13)
            phase_recurrent("xlstm-125m", 14)
        check_family_launches(seen)
        with b3_path("llava, seamless, zamba2 smoke f32 on the card (phase 15)"), \
                norm_rope_path("llava, seamless, zamba2 smoke f32 on the card (phase 15)"):
            phase_families_cpu_parity(15)
        with b3_path("dispatch phi4-mini + deepseek-v2 + smoke lane"), \
                b2_path("dispatch phi4-mini + deepseek-v2 + smoke lane"), \
                b6_path("dispatch phi4-mini + deepseek-v2 + smoke lane"), \
                norm_rope_path("dispatch phi4-mini + deepseek-v2 + smoke lane"):
            dispatch = phase_dispatch(16)
        with b3_path("worker plane phi4-mini (in process)"), \
                norm_rope_path("worker plane phi4-mini (in process)"):
            workers = phase_workers(17)
        B3_BY_PATH["worker plane phi4-mini (in the worker)"] = \
            workers["launches"].get("decode_attention", 0)
        NORM_ROPE_BY_PATH["worker plane phi4-mini (in the worker)"] = {
            name: workers["launches"].get(name, 0)
            for name in ("rms_norm", "rms_norm_bwd", "rotary")}
        with b3_path("journal recovery phi4-mini"), norm_rope_path("journal recovery phi4-mini"):
            journal = phase_journal(18, workers)
        with b2_path("train (19b, 19d, 19e)"):
            train = phase_train(19)
        phi4, smoke = train["phi4"], train["smoke"]
        with b3_path("synchronized decode_32k phi4-mini-3.8b"), \
                norm_rope_path("synchronized decode_32k and prefill_32k phi4-mini-3.8b"):
            launch = phase_launch(20)
        with b2_path("sharded (phase 21)"):
            sharded = phase_sharded(21, phi4.pop("reference"),
                                    train["deepseek"].pop("reference"))
        long = phase_long(22)
        with b6_path("deepseek-v2-236b decode_32k share (phase 23)"), \
                norm_rope_path("deepseek-v2-236b decode_32k share (phase 23)"):
            latent32k = phase_latent_32k(23)
    idle = sorted(name for name, n in B3_BY_PATH.items() if n == 0)
    if idle:
        fail(f"B3 was launched no time on the paths {idle}")
    unchecked = sorted(b3_seen - set(b3_record.pop("checked_instances")))
    if unchecked:
        fail(f"the paths ran B3 kernels (dtype, hd, rows) phase 3b never checked: {unchecked}")
    if decode.layout_copies:
        fail(f"the paths made {decode.layout_copies} layout copies for B3")
    idle = sorted(name for name, n in B3_PARTIALS_BY_PATH.items() if n == 0)
    if idle or not B3_PARTIALS_BY_PATH:
        fail(f"B3's partials form was launched no time on the paths {idle}")
    say(f"B3 launches by path: {B3_BY_PATH}, of them the partials form: {B3_PARTIALS_BY_PATH}; "
        f"kernels (dtype, hd, rows) the paths ran, each checked in phase 3b: {sorted(b3_seen)}; "
        "0 layout copies")
    idle = sorted(name for name, n in B6_BY_PATH.items() if n == 0)
    if idle or len(B6_BY_PATH) < 4:
        fail(f"B6 was launched no time on the paths {idle} (of {sorted(B6_BY_PATH)})")
    if latent.layout_copies:
        fail(f"the paths made {latent.layout_copies} layout copies for B6")
    say(f"B6 launches by path: {B6_BY_PATH}; 0 layout copies")
    idle = sorted(name for name, n in B7_BY_PATH.items() if n == 0)
    if idle or len(B7_BY_PATH) < 4:
        fail(f"B7 was launched no time on the paths {idle} (of {sorted(B7_BY_PATH)})")
    if expanded.layout_copies:
        fail(f"the paths made {expanded.layout_copies} layout copies for B7")
    say(f"B7 calls (forward and backward) by path: {B7_BY_PATH}; 0 layout copies")
    idle = sorted(name for name, n in B4_BY_PATH.items() if n == 0)
    if idle:
        fail(f"B4 was launched no time on the paths {idle}")
    say(f"B4 kernels by path: {B4_BY_PATH}")
    idle = sorted(name for name, n in B5_BY_PATH.items() if n == 0)
    if idle:
        fail(f"B5 was launched no time on the paths {idle}")
    say(f"B5 kernels by path: {B5_BY_PATH}")
    idle = sorted(name for name in NORM_ROPE_PATHS if not (
        NORM_ROPE_BY_PATH.get(name, {}).get("rms_norm") and NORM_ROPE_BY_PATH[name]["rotary"]))
    if idle:
        fail(f"B8 or B9 was launched no time on the paths {idle}")
    say(f"B8 and B9 calls by path: {NORM_ROPE_BY_PATH}; layout copies B8 {b8.layout_copies}, "
        f"B9 {b9.layout_copies}; in the profiled replays {NORM_ROPE_REPLAYS}")
    # launches: the wrappers' counts over the paths' runs (each path's
    # counts set to 0 just before it), by path under launches_by_path;
    # launches_in_replays: the kernels the profiler saw in the paths'
    # profiled CUDA-graph replays (profiled_replays of them), which bypass
    # the wrappers
    flash_by_path = {"serve phi4-mini-3.8b": launches, "serve arctic-480b": arctic["flash_launches"],
                     "serve llava-next-34b": vlm["served_launches"],
                     "llava-next-34b forward": vlm["forward_launches"],
                     "seamless-m4t-medium encode, forward, decode": audio["launches"],
                     "zamba2-2.7b forward, decode": hybrid["launches"],
                     "dispatch phi4-mini + deepseek-v2 + smoke lane": dispatch["flash_launches"],
                     "worker plane phi4-mini (in the worker)":
                         workers["launches"].get("flash_attention", 0),
                     "journal recovery phi4-mini": journal["launches"],
                     "train phi4-mini-3.8b (eager steps, seal)": phi4["fwd_launches"],
                     "train smoke configs on the card": sum(c[0] for c in smoke.values()),
                     "launch prefill_32k phi4-mini-3.8b (B = 1)": launch["prefill"]["launches"],
                     "sharded train phi4-mini-3.8b on a (1, 1) mesh (eager steps, seal)":
                         sharded["train"]["fwd_launches"],
                     "sharded forward zamba2-2.7b on a (1, 1) mesh":
                         sharded["hybrid"]["launches"]}
    bwd_by_path = {"train phi4-mini-3.8b (eager steps, seal)": phi4["bwd_launches"],
                   "train smoke configs on the card": sum(c[1] for c in smoke.values()),
                   "sharded train phi4-mini-3.8b on a (1, 1) mesh (eager steps, seal)":
                       sharded["train"]["bwd_launches"]}
    pack_by_path = {"nimble branchy cells": pack_launches,
                    "serve arctic-480b": arctic["b2_launches"],
                    "serve deepseek-v2-236b": deepseek["b2_launches"],
                    "dispatch phi4-mini + deepseek-v2 + smoke lane": dispatch["b2_launches"],
                    "train smoke configs on the card": sum(c[2] for c in smoke.values()),
                    "train deepseek-v2-236b 1 layer (19h)": train["deepseek"]["b2_launches"],
                    "train nimble branchy gradients": train["nimble"]["b2_launches"],
                    "sharded forward deepseek-v2-236b on a (1, 1) mesh":
                        sharded["forward"]["b2_launches"],
                    "sharded train deepseek-v2-236b on a (1, 1) mesh (21f)":
                        sharded["deepseek"]["b2_launches"]}
    kernels = [dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:94",
        launches=sum(flash_by_path.values()), launches_by_path=flash_by_path,
        launches_in_replays=(in_replays or 0) + arctic["flash_in_replays"]
        + vlm["flash_in_replays"] + audio["decode"]["flash_in_replay"],
        profiled_replays=(0 if in_replays is None else 1) + 1 + vlm["profiled_replays"] + 1,
        dispatched_in_replays=dispatch["flash_in_replays"],
        train_in_replay=phi4["in_replay"]["flash_fwd"],
        **record,
    ), dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:94",
        note="the gradient of B1: not a TPU kernel (the JAX package has no backward kernel)",
        launches=sum(bwd_by_path.values()), launches_by_path=bwd_by_path,
        launches_in_replays=B1BWD_REPLAYS["kernels"], profiled_replays=B1BWD_REPLAYS["replays"],
        kernels_per_launch=B1BWD_REPLAYS["kernels"] / max(B1BWD_REPLAYS["calls"], 1),
        **train["bwd"],
    ), dict(
        name="stream_pack_matmul", route="cuda",
        source="src/repro_torch/kernels/stream_pack/csrc/stream_pack.cu",
        replaces="src/repro/kernels/stream_pack/kernel.py:46",
        launches=sum(pack_by_path.values()), launches_by_path=pack_by_path,
        launches_in_replays=pack_in_replays + arctic["b2_in_replays"] + deepseek["b2_in_replays"],
        profiled_replays=pack_profiled + arctic["profiled_replays"] + deepseek["profiled_replays"],
        dispatched_in_replays=dispatch["b2_in_replays"],
        variants_by_path=B2_VARIANTS, layout_copies=pack.layout_copies,
        **pack_record, **train["pack"],
    ), dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
        replaces="src/repro/models/layers.py:328",
        note="not a TPU kernel: the native-dtype dots XLA emits for the JAX package's "
             "_sdpa_deferred (and _sdpa's cache form), which the port's plain version "
             "upcasts to float32",
        launches=sum(B3_BY_PATH.values()), launches_by_path=dict(B3_BY_PATH),
        launches_in_replays=B3_REPLAYS["kernels"],
        profiled_replays=B3_REPLAYS["replays"],
        kernels_per_launch=B3_REPLAYS["kernels"] / max(B3_REPLAYS["calls"], 1),
        layout_copies=decode.layout_copies,
        partials_launches=sum(B3_PARTIALS_BY_PATH.values()),
        partials_launches_by_path=dict(B3_PARTIALS_BY_PATH), long_500k=long,
        **b3_record,
    ), dict(
        name="adamw", route="cuda",
        source="src/repro_torch/kernels/adamw/csrc/adamw.cu",
        replaces="none: not a TPU kernel; XLA's fusion of src/repro/optim/adamw.py:29-71 "
                 "inside the jitted step (src/repro/launch/train.py:76)",
        note="launches count kernels: a step is one sum of squares and one update a leaf "
             "and one finish; ms, plain_ms, bound_ms and library_ms are over phi4-mini's "
             "291 leaves in a CUDA graph",
        launches=sum(B4_BY_PATH.values()), launches_by_path=dict(B4_BY_PATH),
        launches_in_replays=B4_REPLAYS["kernels"], profiled_replays=B4_REPLAYS["replays"],
        kernels_per_launch=B4_REPLAYS["kernels"] / max(B4_REPLAYS["calls"], 1), **train["adamw"],
    ), dict(
        name="cross_entropy", route="cuda",
        source="src/repro_torch/kernels/cross_entropy/csrc/cross_entropy.cu",
        replaces="none: not a TPU kernel; XLA's fusion of src/repro/training/train_lib.py:22-31 "
                 "inside the jitted step (src/repro/launch/train.py:76)",
        note="launches count kernels: a step is one ce_partials and one ce_backward on each "
             "device's vocabulary shard; ms, plain_ms, bound_ms and library_ms are forward + "
             "backward at 19c's logits (1024 x 200192 float32) in a CUDA graph",
        launches=sum(B5_BY_PATH.values()), launches_by_path=dict(B5_BY_PATH),
        launches_in_replays=B5_REPLAYS["kernels"], profiled_replays=B5_REPLAYS["replays"],
        kernels_per_launch=B5_REPLAYS["kernels"] / max(B5_REPLAYS["calls"], 1), **train["ce"],
    ), dict(
        name="latent_attention", route="cuda",
        source="src/repro_torch/kernels/latent_attention/csrc/latent_attention.cu",
        replaces="none: not a TPU kernel; the jnp absorbed attention of "
                 "src/repro/models/mla.py:113-128, which the port's plain version computes "
                 "with a float32 copy of the latent cache and the scores in memory",
        note="launches count calls: a call is one kernel, or two (the attention and the "
             "combine of its split over positions) at the decode shapes; ms, plain_ms, "
             "bound_ms and library_ms are at the served decode (4 slots over 1024 positions) "
             "in a CUDA graph, decode_32k and prefill_512 beside them",
        launches=sum(B6_BY_PATH.values()), launches_by_path=dict(B6_BY_PATH),
        launches_in_replays=B6_REPLAYS["kernels"], profiled_replays=B6_REPLAYS["replays"],
        kernels_per_launch=B6_REPLAYS["kernels"] / max(B6_REPLAYS["calls"], 1),
        layout_copies=latent.layout_copies, decode_32k_model=latent32k, **b6_record,
    ), dict(
        name="expanded_attention", route="cuda",
        source="src/repro_torch/kernels/expanded_attention/csrc/expanded_attention.cu",
        backward_source="src/repro_torch/kernels/expanded_attention/csrc/expanded_attention_bwd.cu",
        replaces="none: not a TPU kernel; the jnp expanded attention of "
                 "src/repro/models/mla.py:90-103 and its gradient through XLA, which the "
                 "port's plain version computed with the (B, N, S, S) float32 scores in memory",
        note="launches count calls, forward and backward: a forward call is one kernel, a "
             "backward call four (pre-pass, dK/dV, dQ, the rope reduce); ms, plain_ms, "
             "bound_ms and library_ms are forward + backward at 19h's shape (q (2, 4096, 128, "
             "128 + 64), v 128, bf16, causal) in a CUDA graph (library_ms: eager), the train_4k "
             "share of a 16x16 device beside them",
        launches=sum(B7_BY_PATH.values()), launches_by_path=dict(B7_BY_PATH),
        launches_in_replays=B7_REPLAYS["kernels"], profiled_replays=B7_REPLAYS["replays"],
        kernels_per_launch=B7_REPLAYS["kernels"] / max(B7_REPLAYS["calls"], 1),
        layout_copies=expanded.layout_copies, train_19h=train["deepseek"], **b7_record,
    )]
    not_tpu = ("none: not a TPU kernel; XLA's fusion of {} inside the jitted step "
               "(src/repro/launch/train.py:76)")
    for kname, rec, note in norm_rope_records(b8_b9_record):
        kernels.append(dict(
            name=kname, route="cuda",
            source=f"src/repro_torch/kernels/{'rotary' if kname == 'rotary' else 'rms_norm'}/"
                   f"csrc/{'rotary' if kname == 'rotary' else 'rms_norm'}.cu",
            replaces=not_tpu.format(
                "src/repro/models/layers.py:79-88 (apply_rope)" if kname == "rotary" else
                "src/repro/models/layers.py:57-67 (apply_norm's rmsnorm), :241-243 and "
                "src/repro/models/mla.py:70 (_rms * scale)"),
            note=note, launches=sum(p[kname] for p in NORM_ROPE_BY_PATH.values()),
            launches_by_path={path: p[kname] for path, p in NORM_ROPE_BY_PATH.items()},
            launches_in_replays=NORM_ROPE_REPLAYS[kname]["kernels"],
            profiled_replays=NORM_ROPE_REPLAYS["replays"],
            kernels_per_launch=NORM_ROPE_REPLAYS[kname]["kernels"]
            / max(NORM_ROPE_REPLAYS[kname]["calls"], 1),
            layout_copies=(b9 if kname == "rotary" else b8).layout_copies,
            chains_19c=train["phi4"]["chains"] if kname == "rms_norm" else None,
            chains_19h=train["deepseek"]["chains"] if kname == "rms_norm" else None,
            **rec))
    say(f"all phases passed in {time.perf_counter() - t_start:.1f}s; seconds by phase: "
        f"{phase_seconds(time.perf_counter())}")
    say(json.dumps({"kernels": kernels}))
    say(f"nvidia-smi: {nvidia_smi()}")
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
