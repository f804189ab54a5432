#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, is right, serves and
trains.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero):

1. Environment: card name and power limit, torch / CUDA / nvcc versions,
   and the build of every kernel source (one ``nvcc`` each, in parallel).
2. ``int8_matmul`` against its plain PyTorch version on the card, at the
   llama-1b (K, N) problems, M in {1, 4, 8, 64, 512, 2048, 4096} (512 and
   4096: a group prefill's rows), x in f32 and bf16: pass if
   ``max|kernel - plain| / max|plain| <= 1e-4`` where the kernel takes two
   passes (M <= 16 in both dtypes, f32 x at any M) and <= 2e-2 for one
   pass (bf16 x, M > 16). A small-M row also prints ``hi_only_rel``, the
   plain version on bf16(x * s) (what one pass would leave), and fails
   unless it exceeds 1e-4, so the gate can tell a dropped pass. Times
   (CUDA events, median of 20 launches, L2 flushed before each), the
   plain version's and one library call's times, the bound, TFLOP/s and
   the design that ran (``mma.sync`` bf16 throughout: M <= 16 two passes
   with the K split in a cluster; M > 16 one pass for bf16 x, two for f32
   x). Then one decode step's 169 calls (M 8, bf16) back to back on
   resident weights between one pair of events, beside cuBLAS bf16 on the
   same weights dequantized and the step's bound.
3. Serving at full width: llama-1b (24 layers, INT8 weights, bf16
   activations, weights drawn on the card from ``--seed``) behind the slot
   ``Scheduler`` with 8 slots and 16 requests (prompts 16-512 tokens,
   16-64 new tokens, greedy). Every request must complete, and every
   prefill and decode step must go through the kernel 7 * 24 + 1 times
   while the plain versions stay unused. Every distinct (M, K, N, x dtype)
   the kernel was launched with is then held against the plain version.
4. Path parity: llama-1b widths at 2 layers, f32, the same INT8 weights;
   ``generate`` on the CPU (plain versions) and on the card (kernel) must
   agree on the first-step logits (2e-2 of max|logits|) and the greedy
   tokens.
5. Training at full width: Q-GaLore pre-training of llama-1b (24 layers,
   INT8 weights, bf16 activations, rank 512, the ``qgalore`` preset) for
   6 steps of 8 x 256 synthetic tokens from ``--seed``. Step 0 refreshes
   all 169 projections by SVD; steps 1-5 are steady steps, each of which
   must launch ``int8_matmul`` 337 times (169 forward, 168 recompute),
   ``int8_matmul_t`` 169 and ``fused_qgalore_update`` 169 times, and no
   plain version. Losses must be finite. Every distinct problem each new
   kernel was launched with is then held against its plain version on the
   run's own inputs (``int8_matmul_t``: 1e-4 of max|plain| on bf16 g as
   the path hands it over, whose products are exact, and 1e-4 on f32 g
   made from it with bits below bf16's, which only the second pass
   carries; the fused update: the weight within one INT8 quantum, codes
   equal on more than 0.999 of the elements, scales and moments within
   1e-5) and timed beside it, each with its design (``int8_matmul_t``:
   ``mma.sync`` bf16, one pass for bf16 g, two for f32 g; the fused
   update: ``mma.sync`` bf16, two passes on the direction, P read
   packed), TFLOP/s, and factor against cuBLAS bf16 or time against the
   bound. The fused update also takes a stress row per side on the run's
   own inputs, at an lr where lr * gscale * max|U| is 256 quanta of the
   old scale: the kernel must hold the same gate there, and the plain
   version run on bf16(dir) (one pass) must fall below 0.99 of equal
   codes (``hi_only_codes_equal``), so the gate can tell a dropped
   second pass. The run writes checkpoints (every 3 steps, into a
   temporary directory); a fresh ``Trainer`` then restores the step-3
   checkpoint through ``maybe_restore`` and runs steps 4-5, whose losses
   must equal the first run's within 1e-6 relative (the save and restore
   seconds are printed).
6. Flash-attention prefill at full width. (a) The kernel against its
   plain version on the card at llama-1b's heads (H 32, d 64, bf16):
   B in {1, 8}, S in {48, 128, 512, 2048}, causal, plus non-causal at
   B 8, S 512 and 2048, a dv = 128 and an f32 case; pass if
   ``max|kernel - plain| / max|plain|`` is at most 1e-4 (f32, three
   passes on split operands) or 1e-2 (bf16 output); the f32 row also
   prints ``hi_only_rel``, the plain arithmetic on bf16-rounded q, k, v
   and P, and fails unless it exceeds 1e-4. Each row is timed beside the
   plain version, one ``scaled_dot_product_attention`` call (the
   yardstick, never on the port's path), the bound, TFLOP/s and the design
   that ran (``mma.sync``, FlashAttention-2: bf16 one pass, f32 three).
   (b) Phase 3's 16
   requests through llama-1b built with ``flash_attention=True``: every
   group prefill must launch ``flash_attention`` 24 times (once a layer),
   run no chunked attention and no plain version; tokens/s, mean TTFT,
   the time of the group prefills (each synchronised, so the host's
   decode loop does not blur the route's effect) and the launches of
   each prefill are printed beside phase 3's, and
   every distinct (B, S) the kernel was launched with is held against
   the plain version. (c) Phase 4's path parity with the flash route on
   both sides (2 layers, f32): 2e-2 of max|logits|, equal greedy tokens,
   4 flash launches on the card and 4 plain ones on the CPU.
7. The unfused Q-GaLore update and the quantizer at llama-1b's shapes:
   ``ops.unfused_qgalore_update`` (``int4_project`` → Adam →
   back-projection → ``sr_requant_update``) for the right-side weights
   2048 x 2048 and 5461 x 2048 at rank 512 must launch ``int4_matmul``
   and ``sr_requant`` once each a weight; ``int4_matmul`` is held to 1e-4
   of max|plain| on the chain's f32 gradients and to 2e-2 on the same in
   bf16 (design, TFLOP/s and factor against cuBLAS printed as in phase
   2), and ``sr_requant`` to equal codes and scales within
   1e-6 on the chain's own inputs (``sr_requant`` also at the other two
   weight shapes); the chain is timed beside the fused path of phase 5's
   kernel. ``quantize_int8`` of all 169 llama-1b weights must launch
   ``blockwise_quant`` 169 times and equal ``core.quant.
   quantize_blockwise`` bit for bit.
8. LLaMA-7B pre-training at full width and depth (32 layers, d 4096, 32
   heads, d_ff 11008, vocab 32000; INT8 weights drawn on the card from
   ``--seed``, bf16 activations): the ``qgalore`` preset at rank 1024
   with the randomized subspace method, 8 x 256 tokens a step at
   ``accum`` 2, 4 steps. Step 0 refreshes all 225 GaLore units; each
   steady step must launch ``int8_matmul`` 898 times (2 microbatches x
   (225 forward + 224 recompute)), ``int8_matmul_t`` 450 and
   ``fused_qgalore_update`` 225, and no plain version. Losses must be
   finite. Printed: the refresh step's and its subspace seconds, the
   median steady step and tokens/s, ``max_memory_allocated`` over the
   steady steps and over the whole phase beside the analytic
   ``memory_report``, and whether the steady peak is under 16 GiB. Every
   distinct problem of the three kernels is then held against its plain
   version as in phase 5 (``int8_matmul`` as in phase 2) and timed.
9. Fine-tuning. (a) ``launch.finetune.main`` with its default flags on
   llama-60m at its published widths and depth (8 layers, d 512, vocab
   32000; rank 8, the first layer, embedding, final norm and head frozen,
   8 steps of 4 x 32 tokens), the report written to
   ``build/finetune_memory.json`` beside the kernels the run built: it
   must say ``qgalore_leq_qlora: true`` (``main`` checks the four
   contracts), the three training kernels must launch and no plain
   version; then one more step from the trained state on the same
   clipped low-rank gradients and uniforms through
   ``transform.qgalore_transform`` (the fused kernel) and
   ``transform.qgalore_reference_chain`` (plain stages): every tuned
   weight within one INT8 quantum, with the share of equal codes
   printed. (b) LLaMA-7B fine-tuning at full width and depth (phase 8's
   model built with ``split_layers=1``) under ``launch.finetune``'s
   rule-set at rank 8 with the randomized subspace method,
   ``update_interval`` 2, 8 x 256 tokens a step, 4 steps (steps 0 and 2
   refresh): the four contracts through ``launch.finetune``'s functions,
   every steady step launching ``int8_matmul`` 449 times (225 forward, 224
   recompute), ``int8_matmul_t`` 225 and ``fused_qgalore_update`` 217 (the
   31 tuned layers x 7) and no plain version; the refresh and steady
   steps, each step's ``max_memory_allocated``, ``memory_report`` beside
   the QLoRA baseline at rank 8; then every distinct kernel problem
   against its plain version as in phase 8.
10. Paged serving. (a) Phase 3's model and 16 requests through
   ``make_scheduler(backend="auto")``, the paged scheduler (block 16,
   chunk 32): 8 slots at the slot pool's memory; the same requests
   behind one shared 256-token system prompt (beside the slot scheduler
   on that traffic; the radix cache must hit); 16 slots at the 8-slot
   block count (more than 8 requests at once, the pool within one
   scratch block of the slot pool's bytes). Every request completes, the
   allocator's invariant holds after each run, and every decode or
   append dispatch launches ``int8_matmul`` 169 times and every fused
   one 338, with no plain version and no ``flash_attention``; every
   distinct problem is then held against the plain version, and both of
   the kernel's paths must appear. Tokens/s, mean TTFT, median dispatch
   ms and peak GiB are printed beside phase 3's, with the share of
   requests whose greedy tokens equal the slot run's (reported: in bf16
   chunked and one-shot prefill round differently). (b) llama-1b widths
   at 2 layers, f32, the same codes on both sides: ``build_append`` at
   chunk widths 1, 5, 16 and 48 within 1e-4 of one-shot prefill on the
   card (last logits and the written cache); 8 shared-prefix requests
   through the paged scheduler on the card and on the CPU (equal greedy
   tokens and ``stats``) and through the card's slot scheduler (equal
   tokens).
11. The dense variants. (a) mistral-nemo-12b, yi-9b, qwen3-32b (qk-norm),
   gemma-7b (GeGLU, head_dim 256, the tied head) and internvl2-2b (the
   VLM backbone) at full width and 8 layers each (of 40, 48, 64, 28 and
   24: ``SERVE_DEPTH``, the cut that keeps the script inside its time
   limit on a slow host), bf16, one at a time: weights
   drawn from ``--seed`` and quantized on the card one layer of a group
   at a time (``init_params(by_layer=True)``; the drawn tree's
   parameters must equal ``model_zoo.count_params``), then 8 requests
   (prompts of 64-512 tokens, 16 greedy new tokens) through
   ``make_scheduler`` with 4 slots (the paged runtime). Every decode or
   append dispatch must launch ``int8_matmul`` 7 x layers times plus one
   for an untied head (twice that a fused one) and ``int8_matmul_t`` once
   for the tied head and never otherwise, with no plain version; then
   the prefill and 4 teacher-forced decode steps at bf16 against the full
   forward (0.1 of max|logits|; see ``BF16_PATH_TOL``), and every
   distinct ``int8_matmul`` problem against its plain version. Tokens/s,
   mean TTFT, median decode dispatch ms, INT8 GiB, peak GiB and launches
   a decode dispatch are printed beside the card's name and power
   limit. (b) Each at f32 and 2 layers, the same codes on the card and
   the CPU: the prefill and 3 decode steps (and for the VLM the forward
   over a patch prefix) within 1e-4 of max|logits|, the card through the
   kernels and the CPU through the plain versions. (c) gemma-7b's tied
   head ``h (M, 3072) bf16 @ deq(E (256000, 3072))^T`` through
   ``int8_matmul_t`` at M = 1, 8, 16 and 2048, against its plain version
   (2e-2 of max|plain|) and timed beside it, cuBLAS bf16 and the bound.
   The phase's wall time is printed.
12. The mixture of experts. (a) qwen3-moe-30b-a3b at full width and 12
   of its 48 layers (128 experts top-8, expert_ff 768), bf16, its INT8
   weights drawn on the card one layer at a time, 8 requests (64-512
   prompt tokens, 16 greedy new) through ``make_scheduler("auto")``,
   which must give the slot scheduler (4 slots): every request
   completes, every prefill is one row at its prompt's exact length, and
   every prefill and decode dispatch launches ``int8_matmul`` 61 times
   (wq, wk, wv, wo and the router a layer, the head) and
   ``int8_matmul_batched`` 36 times (the three expert stacks a layer),
   with no plain version; every distinct problem of both is then held
   against its plain version with phase 2's bars. Printed: tokens/s,
   mean TTFT, the median decode dispatch, a profiled decode step's device
   ms and idle share, INT8 and peak GiB, and the padded share (experts
   with an empty buffer a decode dispatch, mean fill at prefill). (b)
   The prefill and 4 teacher-forced decode steps at bf16 against the full
   forward (0.1 of max|logits|), and at f32 and 2 layers the card against
   the CPU on the same codes (1e-4 of max|logits|, equal greedy tokens).
   (c) ``int8_matmul_batched`` and ``int8_matmul_t_batched`` at E 128,
   (K, N) = (2048, 768) and (768, 2048), C in {4, 32, 160, 512}, bf16 and
   f32: each against its plain version and timed (cold L2, median of 20)
   beside the same work as 128 per-expert launches of the 2-D kernel,
   one ``torch.bmm`` on the bf16 stack and the bound; then 3 Q-GaLore
   steps of the model at full width and 2 layers (rank 128, randomized
   subspace, 8 x 256 tokens), every step's launches held to what the
   code implies (a steady step: 21 ``int8_matmul``, 12
   ``int8_matmul_batched``, 11 ``int8_matmul_t``, 6
   ``int8_matmul_t_batched``, 779 ``fused_qgalore_update``) with no plain
   version, and the batched transpose's problems against its plain
   version as phase 5 holds ``int8_matmul_t``.
13. MLA and multi-token prediction. (a) deepseek-v3-671b at full width
   and 7 of its 61 layers (the 3 leading dense layers and 4 MoE layers
   of 256 experts top-8 with a shared expert; all 61 are ~625 GiB of
   INT8, 7 are ~47.6), bf16, drawn on the card one layer and 32 experts
   at a time, phase 12a's traffic through ``make_scheduler("auto")``
   (the slot scheduler, 4 slots): a prefill launches ``int8_matmul`` 61
   times (``wq_a``, ``wq_b``, ``wkv_a``, ``wkv_b``, ``wo``, the FFN's
   three or the router and shared expert's three a layer, the head) and
   a decode dispatch 54 (``wkv_b`` materialized for the absorbed form),
   each ``int8_matmul_batched`` 12 times, with no plain version; every
   distinct problem of both against its plain version. Printed as 12a's.
   (b) The bf16 decode against the forward (0.1 of max|logits|), and at
   f32, 2 layers (one dense) and 16 of the 256 experts the card against
   the CPU (1e-4 of max|logits|, equal greedy tokens): a prefill, then
   the absorbed decode. (c) Both batched kernels at E 256, (K, N) =
   (7168, 2048) and (2048, 7168), C 4 and 512, bf16, against their plain
   versions and timed as 12c; then 3 Q-GaLore steps with MTP at full
   width, 2 layers (one dense) and 32 of the 256 experts (rank 128,
   randomized subspace, 8 x 256 tokens), every step's launches held to
   what the code implies, ``fused_qgalore_update`` on the steady steps.
   Every cut is printed.
14. xLSTM. (a) xlstm-125m at full width and depth (12 layers: 2 groups
   of 5 mLSTM blocks and 1 sLSTM block), bf16, phase 11a's traffic
   through ``make_scheduler("auto")`` (the slot scheduler, 4 slots,
   one unpadded request a prefill): a prefill and a decode dispatch
   each launch ``int8_matmul`` 59 times (5 an mLSTM block, 4 an sLSTM
   block, the head), with no plain version; the pool's seven state
   leaves must be float32 at a bf16 pool; the slot tokens must equal
   per-request ``generate``'s; one decode row alone and among 4 from the
   same prefill state, at bf16 (reported) and f32 (within 1e-3 of
   max|logits|); a decode step and a 421-token prefill
   profiled (the sLSTM's loop over time and the mLSTM's chunk loop timed
   apart); every distinct problem against its plain version. (b) The bf16
   decode against the forward (0.1 of max|logits|); at f32, one group (6
   layers) and a 300-token prompt (two chunks) the card against the CPU
   (1e-4 of max|logits|, equal greedy tokens); the sLSTM gate projection
   (768, 3072) at f32 x and M 1 and 4 against its plain version (1e-4,
   ``hi_only_rel`` above it) and timed beside cuBLAS f32 and the bound.
   (c) 4 Q-GaLore steps at full width and depth (rank 256, 4 x 512
   tokens, a refresh at step 0), every step's launches held to what the
   code implies, finite losses, one more steady step profiled.
15. The SSM hybrid. (a) zamba2-2.7b at full width and 3 of its 9
   superblocks (18 of 54 layers: a superblock is 5 Mamba2 blocks and a
   site of the shared attention block), bf16, drawn one superblock at a time, phase 11a's traffic
   through ``make_scheduler("auto")`` (the slot scheduler, 4 slots, one
   unpadded request a prefill): a prefill and a decode dispatch each
   launch ``int8_matmul`` 70 times (2 a Mamba2 block, 13 a site, the
   head), with no plain version; the pool's SSM states must be float32
   and its conv windows, K and V bf16; the slot tokens must equal
   per-request ``generate``'s; 14a's decode-row probe; a decode step and
   a prefill profiled (the
   SSD chunk loops timed apart); every distinct problem against its
   plain version. (b) The bf16 decode against the forward (0.1 of
   max|logits|); at f32, one superblock (6 layers) and a 300-token prompt
   (two chunks of 256, the second padded) the card against the CPU
   (within the larger of 1e-4 and the measured amplification x 1e-4,
   equal greedy tokens). (c) The same prompts through a bundle built
   with ``flash_attention=True``: 3 ``flash_attention`` launches a
   prefill, the logits within 0.1 of the einsum route's, every flash
   problem against its plain version; the d = 80 kernel at B 1, S 512,
   32 heads, bf16 and f32, against its plain version and timed beside
   it, SDPA and the bound. (d) 4 Q-GaLore steps at 15a's width and depth
   (rank 512, randomized subspace, 4 x 512 tokens, a refresh at step
   0), every step's launches held to what the code implies (a steady
   step: 139 ``int8_matmul``, 70 ``int8_matmul_t``, 42
   ``fused_qgalore_update``), finite losses, each step's peak, and the
   shared block's gradient norm nonzero at every step; one more steady
   step profiled.
16. The encoder-decoder. (a) seamless-m4t-medium at full width and
   depth (12 + 12 layers, vocab 256206), bf16, drawn one layer at a
   time, through ``engine.generate`` (the slot and paged schedulers
   refuse it by name, as the reference's): two batches of 4 requests of
   512 frames (the stubbed audio frontend), 128-token decoder prompts,
   32 new tokens: a prefill launches ``int8_matmul`` 217 times (84
   encoder, 132 decoder, the head) and a decode step 133 (109 at M 4,
   the 24 cross-attention K and V on the memory at M 2048), no plain
   version; tokens/s from ``generate`` alone, with nothing synchronized
   inside it; the encoder's share of a prefill timed apart, a decode step
   profiled, its cross K/V calls timed apart beside cuBLAS bf16 and the
   bound, the bf16 decode against the forward (0.1 of max|logits|), every
   distinct problem against its plain version. (b) At f32, 2 + 2 layers
   at full width, 2 rows of 256 frames and a 64-token prompt, the card
   against the CPU (within the larger of 1e-4 and the measured
   amplification x 1e-4, equal greedy tokens). (c) 16a's batches
   through a bundle built with ``flash_attention=True``: 12
   ``flash_attention`` launches a prefill (the decoder's self-attention
   only), the logits within 5e-2 of the einsum route's; the d = 64
   kernel at B 4, S 128, 16 heads, bf16 and f32, against its plain
   version and timed beside it, SDPA and the bound. (d) 4 Q-GaLore steps
   at full width and depth (rank 256, randomized, 4 x 512 frames), a
   steady step's 433 ``int8_matmul``, 217 ``int8_matmul_t`` and 217
   ``fused_qgalore_update`` launches held to the code's count, finite
   losses, each step's peak, and the gradient norms of ``frame_norm``
   and ``enc_final_norm`` nonzero at every step; one more steady step
   profiled; then every distinct problem of the three training kernels
   (the head's (1024, 256206) among them) against its plain version, at
   phase 5's bars.
17. Data-parallel training: llama-1b at full width and 4 of its 24
   layers, trained by two ranks on ``cuda:0`` over gloo (NCCL refuses two
   ranks a card; the ranks are spawned after the kernels are built), 8 x
   256 a step (4 rows a rank), rank 512, bf16, ``compress_dp_grads``.
   (a) One refresh step (every layer masked, exact SVD; the stacked
   leaves refreshed distributed) and 3 steady steps, against one process
   on the same global batch and card: step 0's loss (the ranks' mean)
   within 1e-5 relative and every later loss within 1e-3, the
   distributed refresh's similarities within 1e-3 and its INT4
   projections, each column signed as the one process's, over one
   quantum apart in under 2% of entries, each rank's launches a step
   equal to the one process's (step 0's fused updates: the distributed
   layers'); (b) ZeRO with ZeRO-2, the same steps in the same ranks: W
   codes equal to (a)'s in at least 0.9999, the state a rank smaller,
   each rank's peak, and its steady steps' peak, below (a)'s (each step's
   peak and the memory as it starts are printed, and the save's peak);
   (c) (b)'s state after step 2, saved by rank 0, restored into the
   parent while the ranks run their last step, whose step-3 loss is
   (b)'s within 1e-6. Each step's ms a rank, the collectives'
   calls, MB and ms beside ``qgalore.dp_payload_bytes``, the refresh's
   subspace seconds a rank, a ``roofline`` line for (a)'s steady step,
   and rank 0's M = 1024 problems of the three training kernels, taken
   from the steady steps, against their plain versions at phase 5's bars
   with the fused update's stress rows. A rank that fails fails the
   phase.
18. Tensor and expert parallelism, in phase 17's two ranks (no new
   spawn), on the ``(1, 2)`` and ``(2, 1)`` meshes. (a) mistral-nemo-12b
   at full width and 2 of its 40 layers, every matrix split over the
   two ranks (column- and row-parallel INT8 matmuls, the d-split
   embedding, the vocabulary-split head and its vocab-parallel loss), 8 x
   256 a step, bf16, rank 1024, randomized subspace, 4 steps (step 0
   refreshes, the stacked leaves over the combined front), against the
   parent's run of the same steps alone (after 17c): every loss within
   2e-3 relative, the similarities equal across ranks, each rank's
   launches a step equal to the code's count, its INT8 bytes the sharded
   leaves' half plus the replicated ones, the model group's bytes of a
   steady step equal to ``qgalore.tp_payload_bytes``, and each rank's
   refresh-step and steady-step peaks below the one process's; rank 0's
   slice problems of the three training kernels against their plain
   versions. (b) qwen3-moe-30b-a3b at full width and 2 layers,
   expert-parallel (64 of the 128 experts a rank), 2 x 256 a rank, rank
   128, randomized, 2 steps (a refresh and a steady one): at step 0's
   inputs the EP layer against
   ``moe_apply`` on the rank's tokens (bf16 at the batched kernels' bar,
   f32 within 1e-5), the fused updates a steady step equal to the owned
   units, the data group's bytes the non-expert leaves'
   ``dp_payload_bytes`` (and the loss, metrics and clip norm) plus the
   all-to-all's counted from E, C and d, finite losses; rank 0 times the
   batched pair at the run's expert problems. Each step's ms, the
   collectives and a ``roofline`` line for each.
19. Sharded serving, in phase 17's two ranks (no new spawn), after the
   parent's one-process runs of the same traffic (11a's: 4 slots, 8
   requests of 64-512 tokens, 16 new, paged, bf16). (a) llama-1b at full
   width and depth with the weights replicated, its block pool split on
   the ``(1, 2)`` mesh (8 of each 16-token block a rank, the held-keys
   attention combining the two ranks). (b) mistral-nemo-12b at full width
   and 8 of 40 layers (11a's cut) tensor-parallel on ``(1, 2)``: every
   matrix split, the cache on the rank's 4 of 8 kv heads, the head's
   logits gathered. A rank's tokens/s, mean TTFT and median dispatch ms
   beside the one process's, the share of bf16 greedy tokens equal to
   its; gated: each decode dispatch's collectives on the model group
   (calls and bytes) equal to the analytic count, pool bytes a rank half
   the one process's, (b)'s INT8 bytes a rank the matrices' half (the
   norm scales whole), ``int8_matmul`` launches a dispatch as one
   process's; at f32 and 2 layers the tokens of (a)'s paged pool on
   ``(1, 2)`` and of the slot pool on ``(2, 1)`` (the slots over data),
   and of (b), equal to the one process's. Rank 0 holds every
   ``int8_matmul`` problem of the phase against its plain version.

Every bound printed is ``analysis.roofline.kernel_bound`` on the counts
of ``kernels/profile.py`` at the H100's rates (phase 1 fails on a card
without a table), named with what bounds it. Every timed training step
and serving run prints a ``roofline`` line: the ``Roofline`` of its cell
from ``analysis.analytic`` (MFU, share of the measured time and of the
profiled device time, dominant term, useful FLOPs ratio; a serving run's
MFU is tokens/s x one token's model FLOPs over the bf16 peak) with the
card's name and power limit. One more decode step of phase 3 and one
more steady step of phase 5 run under ``profile.recording()`` and the
profiler, and their kernel tables (calls, device ms, bytes, FLOPs,
bound, share) are printed; so are those of 14c's, 15d's and 16d's
profiled steps, and, without device times, of 12c's and 13c's last
steady steps. Before the kernels line all rooflines are printed as one
table, with the seconds the rooflines and the extra recorded steps took,
and written with the kernel tables to ``build/analysis.json``
(``python -m repro_torch.analysis.report build/analysis.json``).

``python3 chip_smoke.py --only 12`` (or ``1,12``, ``2`` to ``9``, ``11``
to ``19``) runs those phases alone for development and prints no
kernels line and no result; ``--only 18`` (or ``19``) spawns phase 17's
ranks for that phase alone.

The last three lines are the kernels JSON (all seven kernels;
``int8_matmul``'s and ``int8_matmul_t``'s training step, flash's prefill
and ``int4_matmul``'s projections with ``factor`` = ms / library_ms; the
three training kernels also carry their LLaMA-7B pre-training and
fine-tuning rows, ``int8_matmul`` its paged serving runs and both INT8
matmuls phase 11's, 12's and 13's (the expert grid axis counted apart),
``int8_matmul_t`` the tied head's rows; the three training kernels
phase 14's, 15's and 16's launches, ``int8_matmul`` their serving runs
and the sLSTM gates' f32-x rows, ``flash_attention`` phase 15c's and
16c's prefills and their d = 80 and d = 64 rows; the three training
kernels phase 17's launches in both ranks and its M = 1024 rows, and
phase 18's launches, 18a's slice rows and 18b's expert rows;
``int8_matmul`` phase 19's launches and problems),
the ``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``. Without a CUDA device, or without the repository's ``src/``
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path

# This process writes the bytecode of what it imports under the checkout's
# build/ (the installed packages may carry none): phase 17's spawned
# ranks, which inherit the variable, then read it there and start without
# compiling torch's modules again.
sys.pycache_prefix = os.environ.setdefault(
    "PYTHONPYCACHEPREFIX",
    str(Path(__file__).resolve().parent / "build" / "pycache"))
sys.dont_write_bytecode = False

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

TOL = 2e-2
RESUME_TOL = 1e-6    # a resumed step's loss against the first run's
F32_X_TOL = 1e-4     # f32 x: two bf16 passes on the tiled path
KN = [(2048, 2048), (2048, 5461), (5461, 2048), (2048, 32000)]
MS = [1, 4, 8, 64, 512, 2048, 4096]


T0 = time.monotonic()


def log(*a):
    # a phase's header carries the seconds since the start, so a run's log
    # gives each phase's wall time
    if a and str(a[0]).startswith("== "):
        a = (f"[{time.monotonic() - T0:.1f} s]",) + a
    print(*a, flush=True)


# every step's roofline and every recorded kernel table of the run, written
# to build/analysis.json (``python -m repro_torch.analysis.report`` renders
# it), and the seconds the run spent on them
ANALYSIS = {"roofline": [], "kernels": {}, "seconds": 0.0}


def analysis_work(fn):
    """Counts ``fn``'s wall seconds (a roofline, or an extra recorded step
    and its table) into ``ANALYSIS["seconds"]``: what the analysis adds to
    the run."""
    @functools.wraps(fn)
    def timed(*a, **k):
        t0 = time.monotonic()
        try:
            return fn(*a, **k)
        finally:
            ANALYSIS["seconds"] += time.monotonic() - t0
    return timed


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"nvidia-smi failed (exit {out.returncode}): "
                           f"{out.stderr.strip()}")
    return lines[0]


@functools.lru_cache(maxsize=None)
def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return nvidia_smi_line()


def num_layers() -> int:
    from repro_torch.models import model_zoo
    return model_zoo.get_config("llama-1b").num_layers


def small_m(M: int, K: int, N: int) -> bool:
    """Whether ``int8_matmul`` runs an (M, K) x (K, N) problem on its
    small-M path (two passes in both dtypes)."""
    from repro_torch.kernels import int8_matmul as ti8
    return ti8.plan(M, K, N).path == 0


def i8_design(M: int, K: int, N: int, dtype) -> str:
    """Which ``int8_matmul`` kernel design runs a problem."""
    if small_m(M, K, N):
        return ("mma.sync bf16 x2 (hi/lo) small-M, K split in a cluster "
                "(DSMEM reduction)")
    return mma_design(dtype)


def mma_design(dtype) -> str:
    """The tensor-core design that runs an operand of ``dtype``: one bf16
    ``mma.sync`` pass, or two (hi and lo) for f32."""
    return ("mma.sync bf16 x1" if dtype == torch.bfloat16
            else "mma.sync bf16 x2 (hi/lo)")


def i8_tol(M: int, K: int, N: int, dtype) -> float:
    """Two passes (the small-M path in both dtypes, f32 x on any path):
    1e-4 of max|plain|; one bf16 pass: 2e-2."""
    two = small_m(M, K, N) or dtype == torch.float32
    return F32_X_TOL if two else TOL


def i8_hi_only(x, qt) -> float:
    """The error a single bf16 pass would leave: the plain version on
    bf16(x * s), relative to max|plain|."""
    from repro_torch.kernels import ref
    K, N = qt.q.shape
    xs = (x.float()[:, :, None] * qt.scale[None]).to(torch.bfloat16).float()
    got = torch.einsum("mkg,kgb->mgb", xs,
                       qt.q.float().reshape(K, N // 256, 256)).reshape(-1, N)
    want = ref.int8_matmul_ref(x, qt.q, qt.scale, 256)
    return ((got - want).abs().max() / want.abs().max()).item()


def check_against_plain(x, qt) -> tuple[float, float]:
    """Max abs and relative error of the kernel against
    ``int8_matmul_ref`` on the same inputs."""
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.kernels import ref
    got = ti8.int8_matmul(x, qt.q, qt.scale)
    want = ref.int8_matmul_ref(x, qt.q, qt.scale, 256)
    abs_err = (got - want).abs().max().item()
    return abs_err, abs_err / max(want.abs().max().item(), 1e-30)


def time_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each timed with
    CUDA events after the L2 cache was overwritten. A spin kernel before
    the start event keeps the device busy while the host enqueues ``fn``,
    so the events bracket device work and not the host's launch path."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def phase_environment():
    from repro_torch.analysis import roofline
    from repro_torch.kernels import build
    log("== phase 1: environment")
    log("card:", card())
    # every bound and roofline below takes these rates; a card without a
    # table stops the run here
    rates = roofline.peaks(torch.cuda.get_device_name(0))
    log("peaks (NVIDIA H100 SXM data sheet, dense): " + ", ".join(
        f"{k} {v:.3g} {'B/s' if k == 'hbm' else 'FLOP/s'}"
        for k, v in rates.items()))
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} "
        f"sms {torch.cuda.get_device_properties(0).multi_processor_count}")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    log("nvcc:", nvcc[-1] if nvcc else "?")
    try:
        import triton
        log("triton:", triton.__version__)
    except ImportError:
        log("triton: not installed")
    log("cutlass headers:",
        Path("/usr/local/cutlass/include/cutlass/cutlass.h").exists())
    t0 = time.monotonic()
    built = build.build(verbose=True)
    log(f"kernel build: {len(built)} source(s) in "
        f"{time.monotonic() - t0:.1f} s")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_kernels(seed: int):
    from repro_torch.analysis.roofline import kernel_bound
    from repro_torch.kernels import profile as kprof
    from repro_torch.core import quant
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.kernels import ref
    log("== phase 2: int8_matmul against int8_matmul_ref on the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows, max_abs, max_rel, failed = [], 0.0, 0.0, []
    for K, N0 in KN:
        w = torch.randn((K, N0), generator=gen, device=dev) * 0.02
        qt = quant.quantize_blockwise(w, bits=8, symmetric=True)
        w_lib = quant.dequantize(qt, torch.bfloat16)
        N = qt.q.shape[1]
        del w
        for M in MS:
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn((M, K), generator=gen, device=dev).to(dt)
                abs_err, rel = check_against_plain(x, qt)
                max_abs, max_rel = max(max_abs, abs_err), max(max_rel, rel)
                ms = time_ms(lambda: ti8.int8_matmul(x, qt.q, qt.scale),
                             flush)
                plain_ms = time_ms(
                    lambda: ref.int8_matmul_ref(x, qt.q, qt.scale, 256),
                    flush)
                x_lib = x.to(torch.bfloat16)
                lib_ms = time_ms(lambda: torch.matmul(x_lib, w_lib), flush)
                b_ms, b_by = kernel_bound(*kprof.int8_matmul_cost(
                    M, K, N, x.element_size()))
                # a small-M row must also show that one pass would fail
                hi_only = i8_hi_only(x, qt) if small_m(M, K, N) else None
                row = {"M": M, "K": K, "N": N, "n_real": N0,
                       "x": str(dt).replace("torch.", ""), "ms": ms,
                       "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "rel_err": rel,
                       "hi_only_rel": hi_only,
                       "tflops": 2 * M * K * N0 / ms / 1e9,
                       "design": i8_design(M, K, N, dt)}
                rows.append(row)
                ok = rel <= i8_tol(M, K, N, dt) and (hi_only is None
                                              or hi_only > F32_X_TOL)
                if not ok:
                    failed.append(row)
                log(f"  M={M:5d} K={K:5d} N={N:6d} x={row['x']:8s} "
                    f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                    f"tflops={row['tflops']:.1f} [{row['design']}] "
                    f"rel_err={rel:.2e}"
                    + ("" if hi_only is None
                       else f" hi_only_rel={hi_only:.2e}")
                    + f" {'ok' if ok else 'FAIL'}")
                del x, x_lib
        del qt, w_lib
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"int8_matmul disagrees with its plain version "
                             f"on {len(failed)} problem(s): {failed}")
    two = [r["rel_err"] for r in rows
           if r["hi_only_rel"] is not None or r["x"] == "float32"]
    log(f"  {len(rows)} problems agree: max rel err {max_rel:.2e} "
        f"<= tolerance {TOL} (two passes, small-M path or f32 x: "
        f"{max(two):.2e} <= {F32_X_TOL}; one pass would leave hi_only_rel >= "
        f"{min(r['hi_only_rel'] for r in rows if r['hi_only_rel']):.2e})")
    layers = num_layers()
    # one decode step of the main path at 8 slots, bf16: 7 matmuls a layer
    # (wq, wk, wv, wo at (2048, 2048); wi, wg at (2048, 5461); wd at
    # (5461, 2048)) and the head (2048, 32000)
    pick = {(r["K"], r["n_real"]): r for r in rows
            if r["M"] == 8 and r["x"] == "bfloat16"}
    mult = {(2048, 2048): 4 * layers, (2048, 5461): 2 * layers,
            (5461, 2048): layers, (2048, 32000): 1}
    step = {k: sum(pick[s][k] * n for s, n in mult.items())
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    step_by = "bytes" if all(pick[s]["bound_by"] == "bytes"
                             for s in mult) else "operations"
    log(f"  decode step (M=8, bf16, {7 * layers + 1} calls), sum of "
        "per-call times: " + " ".join(f"{k}={v:.4f}" for k, v in step.items()))
    step["sequence"] = decode_sequence(seed)
    return rows, step, step_by, max_abs, max_rel


def sequence_ms(fn, reps: int = 10) -> tuple:
    """Median device time of ``fn`` (many launches) between one pair of
    events, and the host's time to enqueue it. A long spin kernel before
    the start event keeps the device busy while the host enqueues, so the
    events bracket back-to-back device work only."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(reps):
        torch.cuda._sleep(100_000_000)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        fn()
        stop.record()
        host.append((time.perf_counter() - t) * 1e3)
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), statistics.median(host)


def decode_sequence(seed: int) -> dict:
    """One decode step's ``int8_matmul`` calls at 8 slots, bf16 x (7 a
    layer at llama-1b's 24 layers, then the head), each on its own weight,
    all resident on the card, back to back on the stream between one pair
    of events: 1.29 GB of codes, far past the 50 MB L2, so the sequence is
    cold by itself. Beside it cuBLAS bf16 on the same weights dequantized,
    and the bound of the step's bytes. The codes and scales are drawn
    directly (the arithmetic does not care how they were made)."""
    from repro_torch.analysis.roofline import kernel_bound
    from repro_torch.kernels import profile as kprof
    from repro_torch.kernels import int8_matmul as ti8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    layers = num_layers()
    per_layer = [(2048, 2048)] * 4 + [(2048, 5461)] * 2 + [(5461, 2048)]
    probs = [p for _ in range(layers) for p in per_layer] + [(2048, 32000)]
    weights, xs = [], {}
    for K, N0 in probs:
        N = -(-N0 // 256) * 256
        q = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        q[:, N0:] = 0
        sc = torch.rand((K, N // 256), generator=gen, device=dev) * 2e-4 \
            + 1e-4
        weights.append((q, sc, N0))
        if K not in xs:
            xs[K] = torch.randn((8, K), generator=gen,
                                device=dev).to(torch.bfloat16)
    ms, host_ms = sequence_ms(lambda: [ti8.int8_matmul(xs[q.shape[0]], q, sc)
                                       for q, sc, _ in weights])
    lib = [(q.float().reshape(q.shape[0], -1, 256) * sc[..., None])
           .reshape(q.shape[0], -1)[:, :n0].to(torch.bfloat16)
           for q, sc, n0 in weights]
    lib_ms, lib_host_ms = sequence_ms(
        lambda: [torch.matmul(xs[w.shape[0]], w) for w in lib])
    b_ms = sum(kernel_bound(*kprof.int8_matmul_cost(
        8, K, -(-N0 // 256) * 256, 2))[0] for K, N0 in probs)
    out = {"calls": len(probs), "ms": ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "host_enqueue_ms": host_ms,
           "library_host_enqueue_ms": lib_host_ms,
           "gbytes_per_s": sum(K * -(-N0 // 256) * 256 for K, N0 in probs)
           / ms / 1e6}
    log(f"  decode step (M=8, bf16, {len(probs)} calls) back to back on "
        f"resident weights: ms={ms:.4f} library_ms={lib_ms:.4f} "
        f"bound_ms={b_ms:.4f} ({out['gbytes_per_s']:.0f} GB/s of codes; "
        f"host enqueue {host_ms:.2f} / {lib_host_ms:.2f} ms, inside the "
        "spin)")
    del weights, lib, xs
    torch.cuda.empty_cache()
    return out


SERVE_SLOTS = 8
SERVE_MAX_PROMPT, SERVE_MAX_NEW = 512, 64
SERVE_WINDOW = SERVE_MAX_PROMPT + SERVE_MAX_NEW


def serving_model(seed: int, flash: bool = False):
    """llama-1b at full width and depth on the card, bf16, its weights
    drawn from ``seed`` and quantized to INT8 as they are drawn."""
    from repro_torch.models import model_zoo
    from repro_torch.serve.params import quantize_leaf
    cfg = model_zoo.get_config("llama-1b")
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16,
                             flash_attention=flash)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = bundle.init_params(gen,
                                leaf_fn=lambda _, t: quantize_leaf(t))
    torch.cuda.synchronize()
    log(f"  init + INT8 quantization on the card: "
        f"{time.monotonic() - t0:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return cfg, bundle, params


def serving_requests(seed: int, vocab: int) -> list:
    """The serving phases' 16 requests: prompts of 16-512 tokens, 16-64
    new tokens, drawn from ``seed``."""
    from repro_torch.serve.scheduler import Request
    rng = np.random.default_rng(seed)
    n_req = 16
    lens = rng.integers(16, SERVE_MAX_PROMPT + 1, size=n_req)
    news = rng.integers(16, SERVE_MAX_NEW + 1, size=n_req)
    return [Request(rid=i, tokens=rng.integers(1, vocab, size=int(lens[i]))
                    .astype(np.int32), max_new_tokens=int(news[i]))
            for i in range(n_req)]


def phase_serving(seed: int, flash: bool = False):
    """Phase 3, or with ``flash`` phase 6's serving run: the same requests
    through a bundle built with ``flash_attention=True``, where every
    group prefill must launch ``flash_attention`` once a layer and never
    the chunked attention or a plain version."""
    from repro_torch.config import ShapeCell
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.models import attention
    from repro_torch.serve.scheduler import Request, Scheduler
    log("== phase 6b: llama-1b serving, prefill through flash_attention"
        if flash else "== phase 3: llama-1b serving through the slot "
        "scheduler")
    cfg, bundle, params = serving_model(seed, flash)
    reqs = serving_requests(seed, cfg.vocab_size)
    n_req, slots = len(reqs), SERVE_SLOTS
    sched = Scheduler(bundle, params, num_slots=slots, max_len=SERVE_WINDOW,
                      dtype=torch.bfloat16, device="cuda")
    # warm-up: first launches, library handles; then a fresh pool
    sched.run([Request(rid=-1, tokens=reqs[0].tokens[:16],
                       max_new_tokens=2)])
    sched.reset()

    step_ms = []
    inner = sched._step

    def timed_step(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*a)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    sched._step = timed_step
    # every distinct problem the kernel is launched with, checked after
    # the run (``ops`` calls the wrapper through its module attribute)
    shapes = set()
    kernel = ti8.int8_matmul

    def recording(x, q, scale, block=256):
        shapes.add((x.shape[0], q.shape[0], q.shape[1], x.dtype))
        return kernel(x, q, scale, block)

    ti8.int8_matmul = recording
    # each prefill's time (synchronised: the route's own effect, apart
    # from the host's decode loop), launches and chunked-attention blocks,
    # and every distinct (B, S) the flash kernel is launched with
    prefills, prefill_ms, flash_shapes, dense = [], [], set(), []
    k_flash, k_dense, k_prefill = (tflash.flash_attention,
                                   attention._attend_dense, sched._prefill)

    def rec_flash(q, k, v, *, causal=True):
        flash_shapes.add((q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                          q.shape[3], v.shape[3], causal, q.dtype))
        return k_flash(q, k, v, causal=causal)

    def rec_dense(*a, **k):
        dense.append(1)
        return k_dense(*a, **k)

    def rec_prefill(*a):
        before, n_dense = Counter(LAUNCHES), len(dense)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = k_prefill(*a)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        prefills.append(({n: LAUNCHES[n] - before[n] for n in LAUNCHES
                          if LAUNCHES[n] != before[n]},
                         len(dense) - n_dense))
        return out

    sched._prefill = rec_prefill
    if flash:
        tflash.flash_attention, attention._attend_dense = rec_flash, rec_dense
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.monotonic()
    try:
        comps = sched.run(reqs)
        torch.cuda.synchronize()
    finally:
        ti8.int8_matmul = kernel
        tflash.flash_attention, attention._attend_dense = k_flash, k_dense
        sched._prefill = k_prefill
    wall = time.monotonic() - t0
    counts = dict(LAUNCHES)
    st = sched.stats
    by_rid = {c.rid: c for c in comps}
    problems = []
    if st["admitted"] != n_req or st["retired"] != n_req:
        problems.append(f"admitted/retired {st['admitted']}/{st['retired']}")
    for r in reqs:
        c = by_rid.get(r.rid)
        if c is None or len(c.tokens) != r.max_new_tokens:
            problems.append(f"request {r.rid} incomplete")
        elif not all(0 <= t < cfg.vocab_size for t in c.tokens):
            problems.append(f"request {r.rid} token out of range")
    per_call = 7 * cfg.num_layers + 1
    calls = st["prefills"] + st["decode_steps"]
    launched = counts.get("int8_matmul", 0)
    if launched != per_call * calls:
        problems.append(f"int8_matmul launches {launched}"
                        f" != {per_call} x {calls}")
    if any(n.endswith("_ref") or n.startswith("deq_") for n in counts):
        problems.append(f"plain versions ran on the main path: {counts}")
    if flash:
        for i, (launches, n_dense) in enumerate(prefills):
            if launches.get("flash_attention") != cfg.num_layers or n_dense:
                problems.append(f"prefill {i}: launches {launches}, "
                                f"{n_dense} chunked attention blocks")
        if len(prefills) != st["prefills"]:
            problems.append(f"{len(prefills)} prefills seen of "
                            f"{st['prefills']}")
    elif counts.get("flash_attention"):
        problems.append(f"flash_attention ran with the route off: {counts}")
    n_tok = sum(len(c.tokens) for c in comps)
    result = {"tokens_per_s": n_tok / wall, "wall_s": wall,
              "tokens": n_tok,
              "mean_ttft_s": float(np.mean([c.ttft for c in comps])),
              "median_decode_step_ms": statistics.median(step_ms),
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "stats": st, "launches": counts,
              "launches_per_step": launched / max(calls, 1),
              "prefill_ms_total": sum(prefill_ms),
              "median_prefill_ms": statistics.median(prefill_ms),
              "tokens_by_rid": {c.rid: c.tokens for c in comps}}
    if flash:
        result["launches_per_prefill"] = [p[0] for p in prefills]
    log(f"  {n_req} requests, {slots} slots: {n_tok} tokens in {wall:.2f} s"
        f" -> {result['tokens_per_s']:.1f} tok/s; mean TTFT "
        f"{result['mean_ttft_s']:.3f} s; median decode step "
        f"{result['median_decode_step_ms']:.2f} ms; {len(prefill_ms)} "
        f"prefills {result['prefill_ms_total']:.1f} ms in all (median "
        f"{result['median_prefill_ms']:.2f} ms); peak "
        f"{result['peak_gib']:.2f} GiB; stats {st}; launches {counts}")
    if flash:
        log(f"  launches of each prefill: {result['launches_per_prefill']}")
    if problems:
        raise AssertionError("serving: " + "; ".join(problems))
    # the decode step's cell: every slot at the longest prompt's context
    cell = ShapeCell("serve", SERVE_MAX_PROMPT, slots, "decode")
    if flash:
        result["roofline"] = step_roofline(
            "6b", cfg, cell, result["median_decode_step_ms"],
            tokens_per_s=result["tokens_per_s"])
        del sched, params
        torch.cuda.empty_cache()
        result.update(check_flash_shapes(flash_shapes, seed))
        return result
    result.update(check_shapes(shapes, seed))
    step = sched_stepper(sched, reqs[:slots])
    result.update(profile_decode(step))
    result["roofline"] = step_roofline(
        "3", cfg, cell, result["median_decode_step_ms"],
        tokens_per_s=result["tokens_per_s"],
        device_ms=result["profile_step_device_ms"])
    result.update(recorded_kernels("phase 3's decode step (llama-1b, "
                                   f"{slots} slots)", step))
    del sched, params
    torch.cuda.empty_cache()
    return result


def check_shapes(shapes, seed: int) -> dict:
    """Hold the kernel against its plain version at every (M, K, N, x
    dtype) the serving run launched it with, on fresh seeded inputs."""
    from repro_torch.core import quant
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    max_abs, max_rel, failed = 0.0, 0.0, []
    for K, N in sorted({(k, n) for _, k, n, _ in shapes}):
        qt = quant.quantize_blockwise(
            torch.randn((K, N), generator=gen, device=dev) * 0.02,
            bits=8, symmetric=True)
        for M, _, _, dt in sorted((s for s in shapes if s[1:3] == (K, N)),
                                  key=lambda s: (s[0], str(s[3]))):
            x = torch.randn((M, K), generator=gen, device=dev).to(dt)
            abs_err, rel = check_against_plain(x, qt)
            max_abs, max_rel = max(max_abs, abs_err), max(max_rel, rel)
            if rel > i8_tol(M, K, N, dt):
                failed.append((M, K, N, str(dt), rel))
        del qt
    torch.cuda.empty_cache()
    ms = sorted({s[0] for s in shapes})
    log(f"  {len(shapes)} distinct launch problems of the run (M in "
        f"{ms}) against the plain version: max rel err {max_rel:.2e}, "
        f"tolerance {F32_X_TOL} (M <= 16 or f32 x) or {TOL}")
    if failed:
        raise AssertionError(f"int8_matmul disagrees with its plain version "
                             f"at serving problems: {failed}")
    return {"checked_problems": len(shapes), "check_max_abs_err": max_abs,
            "check_max_rel_err": max_rel}


def device_rows(prof) -> list:
    """``(name, device us, calls)`` of the kernels the device ran. Only
    device-side events count: a host op's own device time repeats the
    kernels it launched (a kernel bound with ``ctypes`` is attributed to
    the host op around it), and summing both would count them twice."""
    from torch.autograd import DeviceType
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


@analysis_work
def step_roofline(tag: str, cfg, cell, measured_ms: float, *,
                  rank: int = 128, tokens_per_s=None, device_ms=None
                  ) -> dict:
    """The analytic roofline of a timed step (``analysis.roofline``,
    ``Roofline.for_step``): MFU, share, dominant term and useful FLOPs
    ratio, beside the card's name and power limit. A serving run's MFU is
    its tokens/s x one token's model FLOPs over the bf16 peak; its share
    is the decode step's bound over the median decode step, and over the
    step's device time where it was profiled (``device_ms``)."""
    from repro_torch.analysis import roofline
    r = roofline.Roofline.for_step(cfg, cell, measured_ms / 1e3, rank=rank)
    row = {"name": f"{tag} {cfg.name} {cell.kind} {cell.global_batch} x "
                   f"{cell.seq_len}", **r.row(), "card": card()}
    what = "step"
    if tokens_per_s is not None:
        row.update(mfu=roofline.serving_mfu(cfg, tokens_per_s),
                   tokens_per_s=tokens_per_s)
        what = f"{tokens_per_s:.1f} tokens/s"
    if device_ms:
        row["device_ms"] = device_ms
        row["device_share"] = r.bound_s * 1e3 / device_ms
    ANALYSIS["roofline"].append(row)
    log(f"  roofline {row['name']}"
        + (f" (rank {rank})" if cell.kind == "train" else "")
        + f": mfu {row['mfu']:.3g} ({what}), share {r.share:.3g} of "
        f"{measured_ms:.2f} ms"
        + (f" ({row['device_share']:.3g} of {device_ms:.2f} device ms)"
           if device_ms else "")
        + f", bound {r.bound_s * 1e3:.3f} ms, dominant {r.dominant}, "
        f"useful_flops_ratio {r.useful_flops_ratio:.3f}, mfu_bound "
        f"{r.mfu_bound:.3f}; {card()}")
    return row


def kernel_report(title: str, snap: dict, dev: dict, launched: dict
                  ) -> dict:
    """A recording's kernel table (``report.kernel_table``): each kernel's
    recorded calls, bytes and FLOPs beside the device ms of the functions
    it launched (``dev``; "not measured" where empty), its bound and
    share. The rows must count the ``launched`` kernels."""
    from repro_torch.analysis import report
    from repro_torch.kernels import profile as kprof
    launched = {n: c for n, c in launched.items() if c}
    if kprof.launches_by_kernel(snap) != launched:
        raise AssertionError(f"{title}: recorded rows "
                             f"{kprof.launches_by_kernel(snap)} != launches "
                             f"{launched}")
    ANALYSIS["kernels"][title] = {"snapshot": snap, "device_ms": dev}
    log(f"  kernels of {title}, recorded ({card()}):")
    for line in report.kernel_table(snap, dev).splitlines():
        log("    " + line)
    return {"kernel_table": report.kernel_rows(snap, dev)}


@analysis_work
def recorded_kernels(title: str, run) -> dict:
    """One more call of ``run`` (a steady training step or a decode step,
    after the counted runs) under ``profile.recording()`` and the profiler
    (device activity only), and its :func:`kernel_report`. If the profiler
    fails, the device times read "not measured" and the error is kept."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import profile as kprof
    torch.cuda.synchronize()
    kprof.reset()
    before, err, dev = Counter(LAUNCHES), None, {}
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with kprof.recording():
                run()
            torch.cuda.synchronize()
        dev = kprof.device_ms(device_rows(prof))
    except RuntimeError as e:
        err = str(e)
        log(f"  PROFILER FAILED: {e}")
    snap = kprof.snapshot()
    kprof.reset()
    return dict(kernel_report(title, snap, dev, {
        n: LAUNCHES[n] - before[n] for n in LAUNCHES}),
        kernel_table_error=err)


def sched_stepper(sched, reqs):
    """``sched``'s ``step`` with every slot in flight: the scheduler reset,
    ``reqs`` submitted and its first step (admission prefill and first
    decode) taken, outside any count."""
    sched.reset()
    for r in reqs:
        sched.submit(r)
    sched.step()
    return sched.step


def profile_decode(step, steps: int = 5) -> dict:
    """Device busy time against the host clock over ``steps`` calls of
    ``step``, one decode step each, set up by the caller (after the timed
    run, outside its counts). If the profiler fails, its numbers are null
    and the error is kept."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as e:
        log(f"  PROFILER FAILED: {e}")
        return {"profile_step_wall_ms": None, "profile_step_device_ms": None,
                "device_idle_share": None, "profile_error": str(e)}
    rows = device_rows(prof)
    busy_ms = sum(t for _, t, _ in rows) / 1e3
    log(f"  profiled {steps} decode steps: wall {wall_ms / steps:.2f} ms a "
        f"step, device busy {busy_ms / steps:.2f} ms a step, idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    top = []
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"    device {t / 1e3 / steps:8.3f} ms/step  {n // steps:5d} "
            f"calls/step  {key[:80]}")
        top.append({"kernel": key[:80], "ms_per_step": t / 1e3 / steps,
                    "calls_per_step": n // steps})
    host = sorted(((e.key, e.self_cpu_time_total, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])[:8]
    for key, t, n in host:
        log(f"    host   {t / 1e3 / steps:8.3f} ms/step  "
            f"{n // steps:5d} calls/step  {key[:80]}")
    return {"profile_step_wall_ms": wall_ms / steps,
            "profile_step_device_ms": busy_ms / steps,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "profile_top": top}


def to_cpu(t):
    """A parameter tree's copy on the CPU (QTensor.to and Tensor.to
    alike)."""
    if isinstance(t, dict):
        return {k: to_cpu(v) for k, v in t.items()}
    return t.to("cpu")


def phase_parity(seed: int, flash: bool = False):
    """Phase 4, or with ``flash`` phase 6c: both bundles built with
    ``flash_attention=True``, so the card's prefill runs the flash kernel
    and the CPU's its plain version."""
    from repro_torch.config import replace
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import model_zoo
    from repro_torch.serve import engine
    from repro_torch.serve.params import quantize_leaf
    log("== phase 6c: path parity of the flash route, card against CPU"
        if flash else "== phase 4: path parity, card (kernel) against CPU "
        "(plain)")
    cfg = replace(model_zoo.get_config("llama-1b"), num_layers=2)
    gpu = model_zoo.build(cfg, device="cuda", dtype=torch.float32,
                          flash_attention=flash)
    cpu = model_zoo.build(cfg, device="cpu", dtype=torch.float32,
                          flash_attention=flash)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    p_gpu = gpu.init_params(
        gen, leaf_fn=lambda _, t: quantize_leaf(t))
    p_cpu = to_cpu(p_gpu)
    rng = np.random.default_rng(seed + 1)
    lengths = [12, 7]
    toks = np.zeros((2, 12), np.int32)
    for i, L in enumerate(lengths):
        toks[i, :L] = rng.integers(1, cfg.vocab_size, size=L)
    batch = {"tokens": torch.from_numpy(toks),
             "lengths": torch.tensor(lengths, dtype=torch.int32)}
    out = {}
    for name, bundle, params in (("cpu", cpu, p_cpu), ("gpu", gpu, p_gpu)):
        LAUNCHES.clear()
        dev = bundle.device
        b = {k: v.to(dev) for k, v in batch.items()}
        logits, _ = engine.build_prefill(bundle, 24)(params, b)
        gen_toks, _ = engine.generate(bundle, params, b, steps=8,
                                      max_len=24, device=dev)
        out[name] = (logits.float().cpu(), gen_toks.cpu(), dict(LAUNCHES))
    (l_c, t_c, n_c), (l_g, t_g, n_g) = out["cpu"], out["gpu"]
    rel = ((l_g - l_c).abs().max() / l_c.abs().max()).item()
    log(f"  first-step logits rel err {rel:.2e}; tokens cpu "
        f"{t_c.tolist()} gpu {t_g.tolist()}; launches cpu {n_c} gpu {n_g}")
    if not n_g.get("int8_matmul") or n_g.get("deq_matmul"):
        raise AssertionError(f"card run did not go through the kernel: {n_g}")
    if not n_c.get("deq_matmul") or n_c.get("int8_matmul"):
        raise AssertionError(f"CPU run did not take the plain path: {n_c}")
    # one prefill of ``build_prefill`` and one of ``generate``, 2 layers
    want = {"flash_attention": 4} if flash else {}
    if {n: c for n, c in n_g.items() if n.startswith("flash")} != want or \
            n_c.get("flash_attention_ref", 0) != want.get("flash_attention",
                                                          0):
        raise AssertionError(f"flash launches: card {n_g}, CPU {n_c}")
    if rel > TOL or not torch.equal(t_c, t_g):
        raise AssertionError(f"path parity failed: rel {rel:.2e}, tokens "
                             f"{t_c.tolist()} vs {t_g.tolist()}")
    return rel


def run_counted(tr, steps: int, names, at_step=None) -> list:
    """``tr.run(steps)`` with, for each step, its loss, grad norm, host
    seconds (the trainer's clock around the step, which ends on the
    metrics' copy to the host, so the device work is done) and the
    launches of each of ``names`` it made; ``at_step(step)`` runs (after
    a synchronize) before each step."""
    from repro_torch.kernels import LAUNCHES
    snaps = {}

    def hook(step):
        torch.cuda.synchronize()
        snaps[step] = Counter(LAUNCHES)
        if at_step is not None:
            at_step(step)

    first = tr.start_step
    tr.fault_hook = hook
    try:
        hist = tr.run(steps)
    finally:
        tr.fault_hook = None
    torch.cuda.synchronize()
    snaps[steps] = Counter(LAUNCHES)
    rows = []
    for h in hist:
        s = h["step"]
        if s < first:
            continue
        row = {"step": s, "loss": h["loss"], "grad_norm": h["grad_norm"],
               "s": h["dt"], "launches": {n: snaps[s + 1][n] - snaps[s][n]
                                          for n in names}}
        row.update({k: h[k] for k in ("mtp_loss", "aux_loss") if k in h})
        rows.append(row)
        log(f"  step {s}: loss {row['loss']:.4f} grad_norm "
            f"{row['grad_norm']:.4f} {row['s']:.3f} s launches "
            f"{row['launches']}")
    return rows


def time_saves(tr) -> list:
    """Wrap ``tr``'s checkpoint manager so each save (host copy and write)
    records its step and seconds in the returned list."""
    saves, save = [], tr.mgr.save

    def timed(step, state, extra_meta=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        save(step, state, extra_meta)
        tr.mgr.wait()
        saves.append({"step": step, "s": time.perf_counter() - t})
    tr.mgr.save = timed
    return saves


def check_resume(bundle, tcfg, qcfg, ckpt_root: Path, rows, save_s) -> dict:
    """A fresh trainer restores the run's periodic checkpoint (moved alone
    into a directory of its own, so ``maybe_restore`` finds it as the
    latest) and runs the steps after it: its losses must equal the first
    run's within ``RESUME_TOL`` relative."""
    from repro_torch.config import replace
    from repro_torch.train.trainer import Trainer
    every = tcfg.checkpoint_every
    src = ckpt_root / "run" / f"step_{every:08d}"
    (ckpt_root / "resume").mkdir()
    os.rename(src, ckpt_root / "resume" / src.name)
    tr = Trainer(bundle, replace(tcfg, checkpoint_dir=str(
        ckpt_root / "resume")), qcfg)
    torch.cuda.synchronize()
    t = time.perf_counter()
    start = tr.maybe_restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    if start != every + 1:
        raise AssertionError(f"resume: restored to step {start}, want "
                             f"{every + 1}")
    tr.mgr = None
    hist = tr.run(tcfg.steps)
    first = {r["step"]: r["loss"] for r in rows}
    rel = max(abs(h["loss"] - first[h["step"]]) / abs(first[h["step"]])
              for h in hist)
    ok = rel <= RESUME_TOL
    saves = [(x["step"], round(x["s"], 3)) for x in save_s]
    log(f"  resume: checkpoint saves (step, s) {saves}; restore of step "
        f"{every} {restore_s:.3f} s; steps "
        f"{[h['step'] for h in hist]} losses "
        f"{[round(h['loss'], 6) for h in hist]}; largest relative "
        f"difference from the first run {rel:.3e} (limit {RESUME_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    del tr
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"resume: losses differ by {rel:.3e} relative")
    return {"checkpoint_save_s": save_s, "checkpoint_restore_s": restore_s,
            "resume_steps": [h["step"] for h in hist],
            "resume_max_rel_diff": rel}


def phase_training(seed: int):
    """Q-GaLore pre-training of llama-1b for 6 steps: step 0 refreshes
    every projection by SVD, steps 1-5 are steady steps through the fused
    update. Launch counts per step, every distinct kernel problem against
    its plain version, and the kernels timed at the slice's shapes."""
    from repro_torch.config import QGaLoreConfig, TrainConfig
    from repro_torch.core import projector, quant
    from repro_torch.core.optimizers import preset
    from repro_torch.kernels import LAUNCHES, ref
    from repro_torch.kernels import fused_update as tfu
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.models import model_zoo
    from repro_torch.train.trainer import Trainer
    from repro_torch.analysis.roofline import kernel_bound
    from repro_torch.config import ShapeCell
    log("== phase 5: llama-1b Q-GaLore training (rank 512, 8 x 256 tokens)")
    cfg = model_zoo.get_config("llama-1b")
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16)
    qcfg = preset("qgalore", QGaLoreConfig(rank=512))
    ckpt_root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    tcfg = TrainConfig(seed=seed, global_batch=8, seq_len=256, steps=6,
                       learning_rate=1e-3, warmup_steps=2, grad_clip=1.0,
                       log_every=0, checkpoint_dir=str(ckpt_root / "run"),
                       checkpoint_every=3, async_checkpoint=False)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tr = Trainer(bundle, tcfg, qcfg)
    torch.cuda.synchronize()
    n_units = sum(s.nbatch for s in tr.specs if s.galore)
    log(f"  init (weights, INT8, random-orthonormal INT4 P for {n_units} "
        f"GaLore units) on the card: {time.monotonic() - t0:.2f} s")
    save_s = time_saves(tr)

    # the first real inputs of every distinct problem each new kernel is
    # launched with, checked after the run (``ops`` calls the wrappers
    # through their module attributes)
    probs_t, probs_f, calls, svd_s = {}, {}, Counter(), []
    k_t, k_f, svd = ti8.int8_matmul_t, tfu.fused_qgalore_update, \
        projector.compute_subspace

    def rec_t(g, q, scale, block=256):
        key = (g.shape[0], q.shape[0], q.shape[1], g.dtype)
        calls["t", key] += 1
        if key not in probs_t:
            probs_t[key] = (g.clone(), q, scale)
        return k_t(g, q, scale, block)

    def rec_f(*args, **kw):
        q = args[6]
        key = (q.shape[0], q.shape[1], args[3].shape[-1] * 2, kw["side"])
        calls["f", key] += 1
        if key not in probs_f:
            probs_f[key] = ([t.clone() for t in args[:9]], args[9:], kw)
        return k_f(*args, **kw)

    def timed_svd(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = svd(*a, **k)
        torch.cuda.synchronize()
        svd_s.append(time.perf_counter() - t)
        return out

    ti8.int8_matmul_t, tfu.fused_qgalore_update = rec_t, rec_f
    projector.compute_subspace = timed_svd
    names = ("int8_matmul", "int8_matmul_t", "fused_qgalore_update",
             "int8_matmul_ref", "int8_matmul_t_ref",
             "fused_qgalore_update_ref", "deq_matmul", "deq_matmul_t")
    LAUNCHES.clear()
    try:
        rows = run_counted(tr, tcfg.steps, names)
    finally:
        ti8.int8_matmul_t, tfu.fused_qgalore_update = k_t, k_f
        projector.compute_subspace = svd
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = 7 * cfg.num_layers + 1
    want_steady = {"int8_matmul": 2 * per_step - 1,
                   "int8_matmul_t": per_step,
                   "fused_qgalore_update": per_step}
    problems = []
    for r in rows:
        want = dict(want_steady, **({"fused_qgalore_update": 0}
                                    if r["step"] == 0 else {}))
        got = {n: r["launches"][n] for n in want}
        if got != want:
            problems.append(f"step {r['step']} launches {got} != {want}")
        plain = {n: c for n, c in r["launches"].items()
                 if n not in want and c}
        if plain:
            problems.append(f"step {r['step']} ran plain versions {plain}")
        if not np.isfinite(r["loss"]):
            problems.append(f"step {r['step']} loss {r['loss']}")
    ln_v = float(np.log(cfg.vocab_size))
    if not 0.8 * ln_v <= rows[0]["loss"] <= 1.25 * ln_v:
        problems.append(f"first loss {rows[0]['loss']:.3f} far from "
                        f"ln(vocab) = {ln_v:.3f}")
    svd_count = tr.controller.total_svd_count()
    if svd_count != n_units:
        problems.append(f"{svd_count} SVDs at the refresh, want {n_units}")
    steady = [r["s"] for r in rows[1:]]
    tokens = tcfg.global_batch * tcfg.seq_len
    result = {
        "losses": [r["loss"] for r in rows],
        "refresh_step_s": rows[0]["s"], "refresh_svd_s": sum(svd_s),
        "svd_calls": len(svd_s), "svd_units": svd_count,
        "median_steady_step_ms": statistics.median(steady) * 1e3,
        "tokens_per_s": tokens / statistics.median(steady),
        "peak_gib": peak, "launches": counts,
        "launches_per_steady_step": rows[-1]["launches"]}
    log(f"  losses {[round(x, 4) for x in result['losses']]}")
    log(f"  refresh step {result['refresh_step_s']:.2f} s, of it SVD "
        f"{result['refresh_svd_s']:.2f} s ({len(svd_s)} batched calls, "
        f"{svd_count} units); median steady step "
        f"{result['median_steady_step_ms']:.1f} ms -> "
        f"{result['tokens_per_s']:.1f} tokens/s; peak {peak:.2f} GiB")
    log(f"  measured launches per steady step: "
        f"{result['launches_per_steady_step']}")
    if problems:
        raise AssertionError("training: " + "; ".join(problems))
    tr.mgr = None                     # the profiled step writes no checkpoint
    result.update(profile_train_step(tr))
    result["roofline"] = step_roofline(
        "5", cfg, ShapeCell("train", tcfg.seq_len, tcfg.global_batch,
                            "train"), result["median_steady_step_ms"],
        rank=qcfg.rank, device_ms=result["profile_step_device_ms"])
    result.update(recorded_kernels(
        "phase 5's steady training step (llama-1b, rank 512, 8 x 256)",
        lambda: tr.run(tr.start_step + 1)))
    # dW = x^T g on cuBLAS f32: one call a weight, as many FLOPs as its
    # dL/dx call (N padded to the 256 block, as the rows count it); its
    # operands hold bf16 values (ROADMAP B1), so its bound takes the bf16
    # rate, and the f32 rate's figure is printed beside it
    dw = next(r["flops"] for r in result["kernel_table"]
              if r["kernel"] == "int8_matmul_t")
    result["dw_bound_ms"] = {p: kernel_bound(dw, 0, p)[0]
                             for p in ("bf16", "f32")}
    log(f"  cuBLAS f32 dW (x^T g, {per_step} a step, {dw / 1e12:.3f} "
        f"TFLOP): bound {result['dw_bound_ms']['bf16']:.3f} ms at the bf16 "
        f"rate (its operands hold bf16 values), "
        f"{result['dw_bound_ms']['f32']:.3f} ms at the f32 rate")
    del tr
    torch.cuda.empty_cache()
    result.update(check_resume(bundle, tcfg, qcfg, ckpt_root, rows,
                               save_s))
    # launches of each problem in one step: int8_matmul_t runs at every
    # step, the fused update at the steady ones
    mult = {"int8_matmul_t": {}, "fused_qgalore_update": {}}
    for (kind, key), n in calls.items():
        if kind == "t":
            mult["int8_matmul_t"][key[:3]] = n // tcfg.steps
        else:
            mult["fused_qgalore_update"][key] = n // (tcfg.steps - 1)
    result.update(check_train_kernels(probs_t, probs_f, mult, seed))
    return result


SEVEN_B_STEPS = 4        # step 0 refreshes all 225 units; 1-3 are steady
SEVEN_B_ACCUM = 2
MEMORY_CLAIM_GIB = 16.0  # the paper's LLaMA-7B budget


PLAIN_NAMES = ("int8_matmul_ref", "int8_matmul_t_ref",
               "fused_qgalore_update_ref", "deq_matmul", "deq_matmul_t")
TRAIN_KERNELS = ("int8_matmul", "int8_matmul_t", "fused_qgalore_update")


class ProblemRecorder:
    """Wraps the three training kernels' wrappers and
    ``projector.compute_subspace`` while installed (``with``): the first
    inputs of each distinct problem, copied to the host so that neither
    the copies nor the weights they were views of count in the run's
    device memory; the calls of each problem; and the subspace seconds
    and calls of each step (``step``, set by the caller before each).
    Problems are recorded and counted from step ``count_from`` on. With
    ``record`` false it times the subspace calls alone."""

    def __init__(self, record: bool = True):
        self.i, self.t, self.f = {}, {}, {}
        self.calls = Counter()
        self.sub_s, self.sub_n = Counter(), Counter()
        self.step = -1
        self.record = record
        self.count_from = -1    # the first step whose calls are counted

    def __enter__(self):
        from repro_torch.core import projector
        from repro_torch.kernels import fused_update as tfu
        from repro_torch.kernels import int8_matmul as ti8
        k_i, k_t, k_f, sub = ti8.int8_matmul, ti8.int8_matmul_t, \
            tfu.fused_qgalore_update, projector.compute_subspace
        self._saved = (k_i, k_t, k_f, sub)
        host = lambda ts: [t.to("cpu", copy=True) for t in ts]

        def rec_i(x, q, scale, block=256):
            key = (x.shape[0], q.shape[0], q.shape[1], x.dtype)
            if self.step >= self.count_from:
                self.calls["i", key] += 1
                if key not in self.i:
                    self.i[key] = host((x, q, scale))
            return k_i(x, q, scale, block)

        def rec_t(g, q, scale, block=256):
            key = (g.shape[0], q.shape[0], q.shape[1], g.dtype)
            if self.step >= self.count_from:
                self.calls["t", key] += 1
                if key not in self.t:
                    self.t[key] = host((g, q, scale))
            return k_t(g, q, scale, block)

        def rec_f(*args, **kw):
            q = args[6]
            key = (q.shape[0], q.shape[1], args[3].shape[-1] * 2,
                   kw["side"])
            if self.step >= self.count_from:
                self.calls["f", key] += 1
                if key not in self.f:
                    self.f[key] = (host(args[:9]), args[9:], kw)
            return k_f(*args, **kw)

        def timed_sub(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = sub(*a, **k)
            torch.cuda.synchronize()
            self.sub_s[self.step] += time.perf_counter() - t
            self.sub_n[self.step] += 1
            return out

        projector.compute_subspace = timed_sub
        if self.record:
            ti8.int8_matmul, ti8.int8_matmul_t = rec_i, rec_t
            tfu.fused_qgalore_update = rec_f
        return self

    def __exit__(self, *exc):
        from repro_torch.core import projector
        from repro_torch.kernels import fused_update as tfu
        from repro_torch.kernels import int8_matmul as ti8
        (ti8.int8_matmul, ti8.int8_matmul_t, tfu.fused_qgalore_update,
         projector.compute_subspace) = self._saved
        return False

    def check(self, steps: int, steady_steps: int, seed: int,
              plain_reps: int = 20) -> dict:
        """Every recorded problem against its plain version on the card
        (``check_i8_problems``, ``check_train_kernels``; the plain
        versions timed over ``plain_reps`` calls), with each problem's
        launches in one step: the matmuls run at every step, the fused
        update at the steady ones."""
        mult = {"int8_matmul": {}, "int8_matmul_t": {},
                "fused_qgalore_update": {}}
        for (kind, key), n in self.calls.items():
            if kind == "i":
                mult["int8_matmul"][key[:3]] = n // steps
            elif kind == "t":
                mult["int8_matmul_t"][key[:3]] = n // steps
            else:
                mult["fused_qgalore_update"][key] = n // steady_steps
        card = lambda ts: [t.cuda() for t in ts]
        out = {"int8_matmul": check_i8_problems(
            {k: card(v) for k, v in self.i.items()}, mult["int8_matmul"],
            plain_reps)}
        out.update(check_train_kernels(
            {k: card(v) for k, v in self.t.items()},
            {k: (card(a), rest, kw) for k, (a, rest, kw) in self.f.items()},
            mult, seed, plain_reps))
        return out


def phase_training_7b(seed: int) -> dict:
    """Q-GaLore pre-training of LLaMA-7B at full width and depth: rank
    1024 with the randomized subspace method, 8 x 256 tokens a step at
    ``accum`` 2. Losses, the refresh step and its subspace seconds, the
    steady steps, launches per step, both memory peaks beside the
    analytic ``memory_report``; then every distinct problem of the three
    training kernels against its plain version."""
    from repro_torch.config import QGaLoreConfig, ShapeCell, TrainConfig
    from repro_torch.core import qgalore
    from repro_torch.core.optimizers import preset
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import model_zoo
    from repro_torch.train.trainer import Trainer
    log("== phase 8: LLaMA-7B Q-GaLore pre-training (32 layers, rank 1024, "
        f"randomized subspace, 8 x 256 tokens at accum {SEVEN_B_ACCUM})")
    cfg = model_zoo.get_config("llama-7b")
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16)
    qcfg = preset("qgalore", QGaLoreConfig(rank=1024,
                                           subspace_method="randomized"))
    tcfg = TrainConfig(seed=seed, global_batch=8, seq_len=256,
                       steps=SEVEN_B_STEPS, learning_rate=1e-3,
                       warmup_steps=2, grad_clip=1.0, log_every=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2 ** 30
    log(f"  device memory held before the phase: {before:.2f} GiB")
    t0 = time.monotonic()
    tr = Trainer(bundle, tcfg, qcfg, accum=SEVEN_B_ACCUM)
    torch.cuda.synchronize()
    n_units = sum(s.nbatch for s in tr.specs if s.galore)
    init_s = time.monotonic() - t0
    report = qgalore.memory_report(tr.state.params, tr.rules, specs=tr.specs)
    log(f"  init on the card: {init_s:.2f} s; {n_units} GaLore units; "
        f"memory_report (GiB): " + ", ".join(
            f"{k} {v:.3f}" for k, v in report.items()))

    rec = ProblemRecorder()
    peaks, held = {}, {}

    def at_step(step):
        # each step's peak (the one before it ends here); the steady peak
        # is the largest of steps 1 on
        peaks[step - 1] = torch.cuda.max_memory_allocated() / 2 ** 30
        held[step] = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        rec.step = step

    LAUNCHES.clear()
    with rec:
        rows = run_counted(tr, tcfg.steps, TRAIN_KERNELS + PLAIN_NAMES,
                           at_step)
    counts = dict(LAUNCHES)
    peaks[tcfg.steps - 1] = torch.cuda.max_memory_allocated() / 2 ** 30
    steady_peak = max(peaks[s] for s in range(1, tcfg.steps))
    phase_peak = max(peaks.values())    # peaks[-1]: the init
    micro = 7 * cfg.num_layers + 1         # dense calls a forward
    want_steady = {"int8_matmul": SEVEN_B_ACCUM * (2 * micro - 1),
                   "int8_matmul_t": SEVEN_B_ACCUM * micro,
                   "fused_qgalore_update": micro}
    problems = []
    for r in rows:
        want = dict(want_steady, **({"fused_qgalore_update": 0}
                                    if r["step"] == 0 else {}))
        got = {n: r["launches"][n] for n in want}
        if got != want:
            problems.append(f"step {r['step']} launches {got} != {want}")
        plain = {n: c for n, c in r["launches"].items()
                 if n not in want and c}
        if plain:
            problems.append(f"step {r['step']} ran plain versions {plain}")
        if not np.isfinite(r["loss"]):
            problems.append(f"step {r['step']} loss {r['loss']}")
    ln_v = float(np.log(cfg.vocab_size))
    if not 0.8 * ln_v <= rows[0]["loss"] <= 1.25 * ln_v:
        problems.append(f"first loss {rows[0]['loss']:.3f} far from "
                        f"ln(vocab) = {ln_v:.3f}")
    if tr.controller.total_svd_count() != n_units:
        problems.append(f"{tr.controller.total_svd_count()} subspaces at "
                        f"the refresh, want {n_units}")
    steady = [r["s"] for r in rows[1:]]
    tokens = tcfg.global_batch * tcfg.seq_len
    under = steady_peak < MEMORY_CLAIM_GIB
    result = {
        "steps": tcfg.steps, "accum": SEVEN_B_ACCUM, "rank": qcfg.rank,
        "subspace_method": qcfg.subspace_method, "units": n_units,
        "init_s": init_s, "losses": [r["loss"] for r in rows],
        "refresh_step_s": rows[0]["s"],
        "refresh_subspace_s": sum(rec.sub_s.values()),
        "subspace_calls": sum(rec.sub_n.values()),
        "median_steady_step_ms": statistics.median(steady) * 1e3,
        "tokens_per_s": tokens / statistics.median(steady),
        "steady_peak_gib": steady_peak, "phase_peak_gib": phase_peak,
        "peak_gib_by_step": {str(k): v for k, v in sorted(peaks.items())},
        "held_before_phase_gib": before,
        "memory_report_gib": report,
        "steady_peak_under_16_gib": under, "launches": counts,
        "launches_per_steady_step": rows[-1]["launches"]}
    log(f"  losses {[round(x, 4) for x in result['losses']]}")
    log(f"  refresh step {result['refresh_step_s']:.2f} s, of it subspace "
        f"{result['refresh_subspace_s']:.2f} s "
        f"({result['subspace_calls']} batched "
        f"calls, {n_units} units); median steady step "
        f"{result['median_steady_step_ms']:.1f} ms -> "
        f"{result['tokens_per_s']:.1f} tokens/s")
    log(f"  measured launches per steady step: "
        f"{result['launches_per_steady_step']} (want {want_steady})")
    result["roofline"] = step_roofline(
        "8", cfg, ShapeCell("train", tcfg.seq_len, tcfg.global_batch,
                            "train"), result["median_steady_step_ms"],
        rank=qcfg.rank)
    log(f"  max_memory_allocated by step (GiB; -1: the init): "
        + ", ".join(f"{s}: {v:.2f}" for s, v in sorted(peaks.items()))
        + "; allocated as each step starts: "
        + ", ".join(f"{s}: {v:.2f}" for s, v in sorted(held.items())))
    log(f"  max_memory_allocated: steady steps {steady_peak:.2f} GiB, whole "
        f"phase (init and the refresh step too) {phase_peak:.2f} GiB; "
        f"memory_report total {report['total_gb']:.2f} GiB (weights "
        f"{report['weights_gb']:.2f}, optimizer {report['optimizer_gb']:.2f}"
        f", of it projection {report['projection_gb']:.3f})")
    log(f"  the steady-step peak of {steady_peak:.2f} GiB is "
        + ("under" if under else "NOT under")
        + f" {MEMORY_CLAIM_GIB:g} GiB")
    if problems:
        raise AssertionError("training 7b: " + "; ".join(problems))
    del tr
    torch.cuda.empty_cache()
    result.update(rec.check(tcfg.steps, tcfg.steps - 1, seed))
    return result


def check_i8_problems(probs, mult: dict, plain_reps: int = 20) -> dict:
    """``int8_matmul`` against its plain version at every distinct problem
    of a training run, on the run's own inputs (``i8_tol``), timed beside
    the plain version (median of ``plain_reps``), cuBLAS bf16 on the
    weight dequantized beforehand, and the bound; with the sums over one
    step's calls (``mult``)."""
    from repro_torch.analysis.roofline import kernel_bound
    from repro_torch.kernels import profile as kprof
    from repro_torch.core import quant
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.kernels import ref
    dev = next(iter(probs.values()))[0].device
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows, failed = [], []
    for (M, K, N, dt), (x, q, scale) in sorted(probs.items(),
                                               key=lambda kv: kv[0][:3]):
        qt = quant.QTensor(q, scale, None, 8, 256, N, "float32")
        abs_err, rel = check_against_plain(x, qt)
        w_lib = quant.dequantize(qt, torch.bfloat16)
        x_lib = x.to(torch.bfloat16)
        row = {"M": M, "K": K, "N": N,
               "x": str(dt).replace("torch.", ""),
               "design": i8_design(M, K, N, dt),
               "ms": time_ms(lambda: ti8.int8_matmul(x, q, scale), flush),
               "plain_ms": time_ms(
                   lambda: ref.int8_matmul_ref(x, q, scale, 256), flush,
                   reps=plain_reps),
               "library_ms": time_ms(lambda: torch.matmul(x_lib, w_lib),
                                     flush),
               "max_abs_err": abs_err, "rel_err": rel,
               "tol": i8_tol(M, K, N, dt),
               "launches_per_step": mult[(M, K, N)]}
        row["bound_ms"], row["bound_by"] = kernel_bound(
            *kprof.int8_matmul_cost(M, K, N, x.element_size()))
        row["tflops"] = 2 * M * K * N / row["ms"] / 1e9
        row["factor"] = row["ms"] / row["library_ms"]
        rows.append(row)
        ok = rel <= row["tol"]
        if not ok:
            failed.append(row)
        log(f"  int8_matmul M={M} K={K} N={N} x={row['x']} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
            f"tflops={row['tflops']:.1f} [{row['design']}] "
            f"factor={row['factor']:.2f} rel_err={rel:.2e} "
            f"{'ok' if ok else 'FAIL'}")
        del w_lib, x_lib
    if failed:
        raise AssertionError(f"int8_matmul disagrees with its plain version "
                             f"at the training run's problems: {failed}")
    sums = {f: sum(r[f] * r["launches_per_step"] for r in rows)
            for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
    sums["launches_per_step"] = sum(r["launches_per_step"] for r in rows)
    sums["tflops"] = sum(2 * r["M"] * r["K"] * r["N"]
                         * r["launches_per_step"] for r in rows) \
        / sums["ms"] / 1e9
    sums["factor"] = sums["ms"] / sums["library_ms"]
    log("  one training step's int8_matmul calls: " + " ".join(
        f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in sums.items()))
    return {"per_shape": rows, "step_sums": sums}


def profile_train_step(tr, title: str = "") -> dict:
    """Device busy time against the host clock over one more steady step
    (after the counted run). Only device activity is recorded: a step
    enqueues up to ~10^5 host ops (xLSTM's time loops), which the
    profiler would time and then take a minute to aggregate, and no
    host row is reported. With a ``title`` the step runs under
    ``profile.recording()`` too (a flag test and a row update a kernel
    call), and its :func:`kernel_report` joins the same step's device
    times. If the profiler fails, its numbers are null and the error is
    kept."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import profile as kprof
    step = tr.start_step
    torch.cuda.synchronize()
    kprof.reset()
    before = Counter(LAUNCHES)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with (kprof.recording() if title else contextlib.nullcontext()):
                tr.run(step + 1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as e:
        log(f"  PROFILER FAILED: {e}")
        return {"profile_step_wall_ms": None, "profile_step_device_ms": None,
                "device_idle_share": None, "profile_error": str(e)}
    rows = device_rows(prof)
    busy_ms = sum(t for _, t, _ in rows) / 1e3
    log(f"  profiled steady step {step}: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    top = []
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"    device {t / 1e3:9.2f} ms {n:6d} calls  {key[:80]}")
        top.append({"kernel": key[:80], "ms": t / 1e3, "calls": n})
    out = {"profile_step_wall_ms": wall_ms, "profile_step_device_ms": busy_ms,
           "device_idle_share": 1 - busy_ms / wall_ms, "profile_top": top}
    if title:
        out.update(kernel_report(title, kprof.snapshot(),
                                 kprof.device_ms(rows), {
                                     n: LAUNCHES[n] - before[n]
                                     for n in LAUNCHES}))
        kprof.reset()
    return out


def f32_beside(g: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """``g`` in float32 with each value moved by up to 2^-8 of itself: bits
    below bf16's precision, so that ``lo = g - bf16(g)`` is not zero and
    a two-pass kernel that drops it shows an error far above ``F32_X_TOL``."""
    g = g.float()
    u = torch.rand(g.shape, generator=gen, device=g.device) * 2 - 1
    return g + g * u * 2 ** -8


FUSED_DESIGN = "mma.sync bf16 x2 (dir hi + lo), INT4 P read packed"
STRESS_QUANTA = 256


def plain_direction(args, count, kw) -> torch.Tensor:
    """The plain version's Adam direction (``ref.fused_qgalore_update_ref``'s
    arithmetic)."""
    from repro_torch.core.adam8bit import bias_correction
    g, m, v = (t.float() for t in args[:3])
    b1, b2 = kw["beta1"], kw["beta2"]
    m_hat = (b1 * m + (1.0 - b1) * g) / bias_correction(b1, count)
    v_hat = (b2 * v + (1.0 - b2) * (g * g)) / bias_correction(b2, count)
    return m_hat / (torch.sqrt(v_hat) + kw["eps"])


def plain_from_dir(dirn, args, lr, kw) -> tuple:
    """The plain version's back-projection, step and SR requantization on a
    given direction (the tail of ``ref.fused_qgalore_update_ref``, op for
    op): the codes, and ``dir @ P^T`` (right) or ``P @ dir`` (left)."""
    from repro_torch.core.quant import true_div
    _, _, _, pq, ps, pz, q, ws, u01 = args
    pb, wb = kw["pblock"], kw["wblock"]
    u4 = torch.stack([(pq & 0xF).float(), ((pq >> 4) & 0xF).float()],
                     dim=-1).reshape(pq.shape[0], -1) - 8.0
    d, r = u4.shape
    P = ((u4.reshape(d, r // pb, pb) - pz[..., None])
         * ps[..., None]).reshape(d, r)
    bp = dirn @ P.T if kw["side"] == "right" else P @ dirn
    upd = kw["gscale"] * bp
    R, C = q.shape
    w = (q.float().reshape(R, C // wb, wb) * ws[..., None]).reshape(R, C)
    if kw["wd"]:
        upd = upd + kw["wd"] * w
    wn = (w - lr * upd).reshape(R, C // wb, wb)
    scale = torch.clamp_min(true_div(wn.abs().amax(dim=-1), 127.0), 1e-12)
    codes = torch.floor(wn / scale[..., None] + u01.reshape(R, C // wb, wb))
    return torch.clamp(codes, -128, 127).reshape(R, C).to(torch.int8), bp


def fused_gate(M, N, args, count, lr, kw) -> dict:
    """The kernel against the plain version on the same inputs: the
    dequantized weight within one INT8 quantum (the plain version's largest
    new scale), codes equal on more than 0.999 of the elements, scales and
    moments within 1e-5 relative."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import fused_update as tfu
    qk, sk, mk, vk = tfu.fused_qgalore_update(*args, count, lr, **kw)
    qp, sp, mp, vp = ref.fused_qgalore_update_ref(*args, count, lr, **kw)
    deq = lambda q_, s_: (q_.float().reshape(M, N // 256, 256)
                          * s_[..., None]).reshape(M, N)
    w_err = (deq(qk, sk) - deq(qp, sp)).abs().max().item()
    quantum = sp.max().item()
    same = (qk == qp).float().mean().item()
    rels = {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            .item() for n, a, b in (("scale", sk, sp), ("m", mk, mp),
                                    ("v", vk, vp))}
    ok = (w_err <= quantum + 1e-6 and same > 0.999
          and max(rels.values()) <= 1e-5)
    return {"max_abs_err": w_err, "quantum": quantum, "codes_equal": same,
            "rel_errs": rels, "ok": ok, "plain_codes": qp}


def check_train_kernels(probs_t, probs_f, mult: dict, seed: int,
                        plain_reps: int = 20) -> dict:
    """Each new kernel against its plain version on the training run's own
    inputs, at every distinct problem it was launched with, then timed at
    those problems (CUDA events, cold L2) beside the plain version, one
    library call where there is one, and the bound. ``mult``: per kernel,
    the launches of each problem in one training step (the sums).

    ``int8_matmul_t`` is held to ``F32_X_TOL`` on both inputs: the run's
    bf16 g (each product of a bf16 value and an INT8 code is exact in f32,
    so only the f32 sums round) and the same g with f32 bits below bf16's
    (``f32_beside``; two passes). For the f32 input the error that its bf16
    rounding alone would leave (``hi_only_rel``) is printed beside it and
    must exceed the bar, so the check can tell a dropped second pass."""
    from repro_torch.analysis.roofline import kernel_bound
    from repro_torch.kernels import profile as kprof
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels import fused_update as tfu
    from repro_torch.kernels import int8_matmul as ti8
    dev = next(iter(probs_t.values()))[0].device
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"int8_matmul_t": [], "fused_qgalore_update": []}
    failed = []
    for (M, K, N, dt), (g_run, q, scale) in sorted(probs_t.items(),
                                                   key=lambda kv: kv[0][:3]):
        w_lib = quant.dequantize(quant.QTensor(q, scale, None, 8, 256, N,
                                               "float32"), torch.bfloat16)
        g_lib = g_run.to(torch.bfloat16)
        lib_ms = time_ms(lambda: torch.matmul(g_lib, w_lib.T), flush)
        # the run's own g (the path's dtype), then f32 values beside it
        gs = (g_run,) if dt == torch.float32 else (g_run,
                                                   f32_beside(g_run, gen))
        for g in gs:
            got = ti8.int8_matmul_t(g, q, scale)
            want = ref.int8_matmul_t_ref(g, q, scale, 256)
            abs_err = (got - want).abs().max().item()
            peak = max(want.abs().max().item(), 1e-30)
            rel = abs_err / peak
            hi_only = None
            if g.dtype == torch.float32:
                hi_only = (ref.int8_matmul_t_ref(g.to(torch.bfloat16), q,
                                                 scale, 256)
                           - want).abs().max().item() / peak
            row = {"M": M, "K": K, "N": N,
                   "g": str(g.dtype).replace("torch.", ""),
                   "on_path": g.dtype == dt, "design": mma_design(g.dtype),
                   "ms": time_ms(lambda: ti8.int8_matmul_t(g, q, scale),
                                 flush),
                   "plain_ms": time_ms(
                       lambda: ref.int8_matmul_t_ref(g, q, scale, 256),
                       flush, reps=plain_reps),
                   "library_ms": lib_ms, "max_abs_err": abs_err,
                   "rel_err": rel, "hi_only_rel": hi_only}
            row["bound_ms"], row["bound_by"] = kernel_bound(
                *kprof.int8_matmul_t_cost(M, K, N, g.element_size()))
            row["tflops"] = 2 * M * K * N / row["ms"] / 1e9
            row["factor"] = row["ms"] / lib_ms
            out["int8_matmul_t"].append(row)
            ok = rel <= F32_X_TOL and (hi_only is None
                                       or hi_only > F32_X_TOL)
            if not ok:
                failed.append(("int8_matmul_t", row))
            log(f"  int8_matmul_t M={M} K={K} N={N} g={row['g']} "
                f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_ms={lib_ms:.4f} bound_ms={row['bound_ms']:.4f} "
                f"({row['bound_by']}) tflops={row['tflops']:.1f} "
                f"[{row['design']}] factor={row['factor']:.2f} "
                f"rel_err={rel:.2e}"
                + ("" if hi_only is None else f" hi_only_rel={hi_only:.2e}")
                + f" {'ok' if ok else 'FAIL'}")
        del w_lib, g_lib
    for (M, N, R, side), (args, (count, lr), kw) in sorted(probs_f.items()):
        gate = fused_gate(M, N, args, count, lr, kw)
        del gate["plain_codes"]
        row = {"M": M, "N": N, "r": R, "side": side, "lr": lr,
               "on_path": True, "design": FUSED_DESIGN,
               "ms": time_ms(lambda: tfu.fused_qgalore_update(
                   *args, count, lr, **kw), flush),
               "plain_ms": time_ms(lambda: ref.fused_qgalore_update_ref(
                   *args, count, lr, **kw), flush, reps=plain_reps),
               "library_ms": None, **gate}
        # every operand read once, every output written once (the
        # kernel's, padded), against the back-projection's 2 m n r
        low, _, _, pq, ps, _, qw, ws, u01 = args
        row["bound_ms"], row["bound_by"] = kernel_bound(
            2 * qw.shape[0] * qw.shape[1] * pq.shape[-1] * 2,
            kprof.fused_update_bytes(low.numel(), pq.numel(), ps.numel(),
                                     qw.numel(), ws.numel(), u01.numel()))
        row["tflops"] = 2 * M * N * R / row["ms"] / 1e9
        row["x_bound"] = row["ms"] / row["bound_ms"]
        out["fused_qgalore_update"].append(row)
        if not row["ok"]:
            failed.append(("fused_qgalore_update", row))
        log(f"  fused_qgalore_update M={M} N={N} r={R} {side} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
            f"x_bound={row['x_bound']:.2f} tflops={row['tflops']:.1f} "
            f"[{FUSED_DESIGN}] weight err {row['max_abs_err']:.2e} (quantum "
            f"{row['quantum']:.2e}) codes equal {row['codes_equal']:.6f} "
            f"rel {row['rel_errs']} {'ok' if row['ok'] else 'FAIL'}")
    # a stress step per side on the run's inputs: lr * gscale * max|U| is
    # STRESS_QUANTA quanta of the old scale, so the step sets the new
    # scales and the plain version run on bf16(dir) (one pass: no lo) must
    # fall below 0.99 of equal codes while the kernel holds the gate
    for want_side in ("right", "left"):
        (M, N, R, side), (args, (count, _), kw) = next(
            kv for kv in sorted(probs_f.items()) if kv[0][3] == want_side)
        dirn = plain_direction(args, count, kw)
        _, bp = plain_from_dir(dirn, args, 0.0, kw)
        lr_s = STRESS_QUANTA * args[7].max().item() \
            / (kw["gscale"] * bp.abs().max().item())
        gate = fused_gate(M, N, args, count, lr_s, kw)
        hi_codes, _ = plain_from_dir(dirn.to(torch.bfloat16).float(), args,
                                     lr_s, kw)
        hi_only = (hi_codes == gate.pop("plain_codes")).float().mean().item()
        row = {"M": M, "N": N, "r": R, "side": side, "lr": lr_s,
               "on_path": False, "stress_quanta": STRESS_QUANTA,
               "design": FUSED_DESIGN, "ms": None, "plain_ms": None,
               "library_ms": None, "bound_ms": None, "bound_by": None,
               **gate, "hi_only_codes_equal": hi_only}
        row["ok"] = gate["ok"] and hi_only < 0.99
        out["fused_qgalore_update"].append(row)
        if not row["ok"]:
            failed.append(("fused_qgalore_update stress", row))
        log(f"  fused_qgalore_update stress M={M} N={N} r={R} {side} "
            f"lr={lr_s:.4g} ({STRESS_QUANTA} quanta) weight err "
            f"{row['max_abs_err']:.2e} (quantum {row['quantum']:.2e}) codes "
            f"equal {row['codes_equal']:.6f} rel {row['rel_errs']} "
            f"hi_only_codes_equal={hi_only:.6f} "
            f"{'ok' if row['ok'] else 'FAIL'}")
    if failed:
        raise AssertionError(f"training kernels disagree with their plain "
                             f"versions: {failed}")
    # one training step's calls, summed over the problems (int8_matmul_t:
    # the rows in the path's own g dtype)
    sums = {}
    for name, key in (("int8_matmul_t", lambda r: (r["M"], r["K"], r["N"])),
                      ("fused_qgalore_update",
                       lambda r: (r["M"], r["N"], r["r"], r["side"]))):
        per = mult[name]
        rows_ = [r for r in out[name] if r.get("on_path", True)]
        sums[name] = {f: sum(r[f] * per[key(r)] for r in rows_)
                      for f in ("ms", "plain_ms", "bound_ms")}
        sums[name]["library_ms"] = None if name != "int8_matmul_t" else \
            sum(r["library_ms"] * per[key(r)] for r in rows_)
        sums[name]["launches_per_step"] = sum(per[key(r)] for r in rows_)
    t_rows = [r for r in out["int8_matmul_t"] if r["on_path"]]
    flops = sum(2 * r["M"] * r["K"] * r["N"] * mult["int8_matmul_t"][
        (r["M"], r["K"], r["N"])] for r in t_rows)
    sums["int8_matmul_t"]["tflops"] = flops / sums["int8_matmul_t"]["ms"] \
        / 1e9
    sums["int8_matmul_t"]["factor"] = sums["int8_matmul_t"]["ms"] \
        / sums["int8_matmul_t"]["library_ms"]
    f_rows = [r for r in out["fused_qgalore_update"] if r["on_path"]]
    flops = sum(2 * r["M"] * r["N"] * r["r"] * mult["fused_qgalore_update"][
        (r["M"], r["N"], r["r"], r["side"])] for r in f_rows)
    sums["fused_qgalore_update"]["tflops"] = \
        flops / sums["fused_qgalore_update"]["ms"] / 1e9
    for name, s in sums.items():
        log(f"  one training step's {name} calls: "
            + " ".join(f"{k}={v:.3f}" if isinstance(v, float) else
                       f"{k}={v}" for k, v in s.items() if v is not None))
    return {"train_kernels": out, "train_kernel_step_sums": sums}


FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
FLASH_DESIGN = {torch.bfloat16: "mma.sync bf16 x1 (FlashAttention-2)",
                torch.float32: "mma.sync bf16 x3 (split hi/lo, "
                               "FlashAttention-2)"}


def flash_hi_only(q, k, v, causal) -> float:
    """The error one bf16 pass would leave in f32 attention: the plain
    arithmetic on bf16-rounded q, k, v and P (the unnormalised
    probabilities, as the kernel feeds them to P V), relative to
    max|plain|."""
    from repro_torch.kernels import ref
    B, S, H, d = q.shape
    G = H // k.shape[2]
    r = lambda t: t.to(torch.bfloat16).float()
    qb, kb, vb = r(q), r(k.repeat_interleave(G, dim=2)), \
        r(v.repeat_interleave(G, dim=2))
    s = torch.einsum("bqhd,bkhd->bhqk", qb, kb) / math.sqrt(d)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    got = torch.einsum("bhqk,bkhd->bqhd", r(e), vb) \
        / e.sum(-1).transpose(1, 2)[..., None]
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    return ((got - want).abs().max() / want.abs().max()).item()


def flash_inputs(B, S, H, KH, d, dv, dtype, gen):
    dev = torch.device("cuda")
    return tuple(torch.randn(sh, generator=gen, device=dev).to(dtype)
                 for sh in ((B, S, H, d), (B, S, KH, d), (B, S, KH, dv)))


def flash_row(B, S, H, KH, d, dv, causal, dtype, gen, flush, timed=True):
    """The kernel against its plain version on fresh inputs of one
    problem; with ``timed``, its time beside the plain version's, the
    library call's and the bound."""
    from repro_torch.analysis.roofline import kernel_bound
    from repro_torch.kernels import profile as kprof
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref
    q, k, v = flash_inputs(B, S, H, KH, d, dv, dtype, gen)
    got = tflash.flash_attention(q, k, v, causal=causal).float()
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    abs_err = (got - want).abs().max().item()
    rel = abs_err / max(want.abs().max().item(), 1e-30)
    del got, want
    row = {"B": B, "S": S, "H": H, "KH": KH, "d": d, "dv": dv,
           "causal": causal, "dtype": str(dtype).replace("torch.", ""),
           "design": FLASH_DESIGN[dtype],
           "max_abs_err": abs_err, "rel_err": rel,
           "ok": rel <= FLASH_TOL[dtype]}
    if dtype == torch.float32:
        # the gate must be able to tell a dropped pass
        row["hi_only_rel"] = flash_hi_only(q, k, v, causal)
        row["ok"] = row["ok"] and row["hi_only_rel"] > FLASH_TOL[dtype]
    if timed:
        row["ms"] = time_ms(lambda: tflash.flash_attention(
            q, k, v, causal=causal), flush)
        row["plain_ms"] = time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal), flush)
        # the yardstick: one library call on (B, H, S, d) views of the same
        # tensors (H == KH here), never on the port's path
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), flush)
        cost = kprof.flash_cost(B, S, H, KH, d, dv, causal,
                                q.element_size())
        row["bound_ms"], row["bound_by"] = kernel_bound(*cost)
        row["tflops"] = cost[0] / row["ms"] / 1e9
    del q, k, v
    return row


def phase_flash_kernels(seed: int):
    """Phase 6a: the flash kernel against its plain version at llama-1b's
    heads (32, d 64), bf16, timed beside the plain version, one
    ``scaled_dot_product_attention`` call and the bound."""
    log("== phase 6a: flash_attention against flash_attention_ref")
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    probs = [(B, S, 32, 32, 64, 64, True, torch.bfloat16)
             for B in (1, 8) for S in (48, 128, 512, 2048)]
    probs += [(8, 512, 32, 32, 64, 64, False, torch.bfloat16),
              (8, 2048, 32, 32, 64, 64, False, torch.bfloat16),
              (8, 512, 32, 32, 64, 128, True, torch.bfloat16),
              (8, 512, 32, 32, 64, 64, True, torch.float32)]
    rows, failed = [], []
    for p in probs:
        row = flash_row(*p, gen, flush)
        rows.append(row)
        if not row["ok"]:
            failed.append(row)
        log(f"  B={row['B']} S={row['S']:5d} d={row['d']} dv={row['dv']} "
            f"causal={row['causal']!s:5s} {row['dtype']:8s} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} bound_ms="
            f"{row['bound_ms']:.4f} ({row['bound_by']}) tflops="
            f"{row['tflops']:.1f} [{row['design']}] rel_err="
            f"{row['rel_err']:.2e}"
            + (f" hi_only_rel={row['hi_only_rel']:.2e}"
               if "hi_only_rel" in row else "")
            + f" {'ok' if row['ok'] else 'FAIL'}")
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version: {failed}")
    return rows


def check_flash_shapes(shapes, seed: int) -> dict:
    """The flash kernel against its plain version at every distinct
    problem the serving run launched it with, on fresh seeded inputs."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    rows = [flash_row(B, S, H, KH, d, dv, causal, dt, gen, None,
                      timed=False)
            for B, S, H, KH, d, dv, causal, dt in sorted(
                shapes, key=lambda t: t[:2])]
    torch.cuda.empty_cache()
    worst = max(r["rel_err"] for r in rows)
    log(f"  {len(rows)} distinct flash problems of the run ((B, S) in "
        f"{[(r['B'], r['S']) for r in rows]}) against the plain version: "
        f"max rel err {worst:.2e}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version at serving problems: {bad}")
    return {"flash_checked_problems": len(rows),
            "flash_check_max_abs_err": max(r["max_abs_err"] for r in rows),
            "flash_check_max_rel_err": worst}


def phase_unfused(seed: int):
    """Phase 7: the unfused Q-GaLore update (``ops.unfused_qgalore_update``:
    ``int4_project`` → Adam → back-projection → ``sr_requant_update``) for
    llama-1b's right-side weights at rank 512, each kernel held against its
    plain version on the chain's own inputs and timed; ``sr_requant`` and
    ``blockwise_quant`` at all four weight shapes; and ``quantize_int8`` of
    all 169 llama-1b weights against ``core.quant.quantize_blockwise``."""
    from repro_torch.analysis.roofline import kernel_bound
    from repro_torch.kernels import profile as kprof
    from repro_torch.core import projector, quant
    from repro_torch.kernels import LAUNCHES, ops, ref
    from repro_torch.kernels import blockwise_quant as tbq
    from repro_torch.kernels import int4_matmul as ti4
    from repro_torch.kernels import sr_requant as tsr
    log("== phase 7: the unfused update and the quantizer at llama-1b's "
        "shapes")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rank, lr, kw = 512, 1e-3, dict(gscale=0.25)
    layers = num_layers()
    probs = {}
    for m, n in ((2048, 2048), (5461, 2048)):
        qt = quant.quantize_blockwise(
            torch.randn((m, n), generator=gen, device=dev) * 0.02, 8,
            symmetric=True)
        P = torch.linalg.qr(torch.randn((n, rank), generator=gen,
                                        device=dev))[0]
        qp = projector.quantize_projection(P, 4, 256)
        grad = torch.randn((m, n), generator=gen, device=dev) * 1e-2
        m32 = torch.randn((m, rank), generator=gen, device=dev) * 1e-3
        v32 = (torch.randn((m, rank), generator=gen, device=dev)
               * 1e-4).abs()
        u01 = torch.rand(qt.q.shape, generator=gen, device=dev)
        probs[m, n] = (qt, qp, grad, m32, v32, u01)

    # the path: one chain per weight, counted; the sr_requant inputs kept
    sr_args, k_sr = {}, tsr.sr_requant

    def rec_sr(q, scale, update, u01, block=256):
        sr_args[tuple(q.shape)] = (q, scale, update.clone(), u01)
        return k_sr(q, scale, update, u01, block)

    tsr.sr_requant = rec_sr
    torch.cuda.synchronize()
    LAUNCHES.clear()
    try:
        for qt, qp, grad, m32, v32, u01 in probs.values():
            new, m_new, v_new = ops.unfused_qgalore_update(
                qt, grad, m32, v32, qp, 1, lr, u01, **kw)
        torch.cuda.synchronize()
    finally:
        tsr.sr_requant = k_sr
    chain_counts = dict(LAUNCHES)
    log(f"  unfused chain at {list(probs)}: launches {chain_counts}")
    want = {"int4_matmul": len(probs), "sr_requant": len(probs)}
    if chain_counts != want:
        raise AssertionError(f"unfused chain launches {chain_counts} != "
                             f"{want}")
    if not (torch.isfinite(m_new).all() and torch.isfinite(v_new).all()
            and torch.isfinite(new.scale).all()):
        raise AssertionError("unfused chain: non-finite outputs")

    failed, i4_rows, chain_rows = [], [], []
    for (m, n), (qt, qp, grad, m32, v32, u01) in probs.items():
        p_deq = projector.maybe_dequantize(qp)
        R = qp.q.shape[1] * 2
        # the chain's own f32 gradient, then the same in bf16; each beside
        # one cuBLAS call in its dtype on a P dequantized beforehand
        for g in (grad, grad.to(torch.bfloat16)):
            got = ti4.int4_matmul(g, qp.q, qp.scale, qp.zero, qp.block)
            want_ = ref.int4_matmul_ref(g, qp.q, qp.scale, qp.zero, qp.block)
            abs_err = (got - want_).abs().max().item()
            rel = abs_err / max(want_.abs().max().item(), 1e-30)
            p_lib = p_deq.to(g.dtype)
            row = {"M": m, "K": n, "R": R,
                   "g": str(g.dtype).replace("torch.", ""),
                   "on_path": g.dtype == grad.dtype,
                   "design": mma_design(g.dtype),
                   "ms": time_ms(lambda: ti4.int4_matmul(
                       g, qp.q, qp.scale, qp.zero, qp.block), flush),
                   "plain_ms": time_ms(lambda: ref.int4_matmul_ref(
                       g, qp.q, qp.scale, qp.zero, qp.block), flush),
                   "library_ms": time_ms(lambda: torch.matmul(g, p_lib),
                                         flush),
                   "max_abs_err": abs_err, "rel_err": rel}
            row["bound_ms"], row["bound_by"] = kernel_bound(
                *kprof.int4_matmul_cost(m, n, R, qp.block, g.element_size()))
            row["tflops"] = 2 * m * n * R / row["ms"] / 1e9
            row["factor"] = row["ms"] / row["library_ms"]
            i4_rows.append(row)
            ok = rel <= (F32_X_TOL if g.dtype == torch.float32 else TOL)
            if not ok:
                failed.append(("int4_matmul", row))
            log(f"  int4_matmul M={m} K={n} R={R} g={row['g']} "
                f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_ms={row['library_ms']:.4f} bound_ms="
                f"{row['bound_ms']:.4f} ({row['bound_by']}) tflops="
                f"{row['tflops']:.1f} [{row['design']}] factor="
                f"{row['factor']:.2f} rel_err={rel:.2e} "
                f"{'ok' if ok else 'FAIL'}")
            del p_lib
        # the unfused chain beside the fused path of the same step (the
        # reference's fused-vs-unfused ratio, benchmarks/kernels_bench.py):
        # project through the dequantized P, then the fused kernel
        low = projector.project(grad, p_deq, "right")
        unf = time_ms(lambda: ops.unfused_qgalore_update(
            qt, grad, m32, v32, qp, 1, lr, u01, **kw), flush)
        fused_kernel = time_ms(lambda: ops.fused_qgalore_update(
            qt, low, m32, v32, qp, 1, lr, u01, side="right", gscale=0.25),
            flush)
        fused = time_ms(lambda: ops.fused_qgalore_update(
            qt, projector.project(grad, p_deq, "right"), m32, v32, qp, 1,
            lr, u01, side="right", gscale=0.25), flush)
        chain_rows.append({"M": m, "N": n, "r": rank, "unfused_ms": unf,
                           "fused_ms": fused,
                           "fused_kernel_ms": fused_kernel,
                           "unfused_over_fused": unf / fused})
        log(f"  chain M={m} N={n} r={rank}: unfused {unf:.4f} ms, fused "
            f"(projection + kernel) {fused:.4f} ms, fused kernel alone "
            f"{fused_kernel:.4f} ms; unfused / fused {unf / fused:.2f}")
        del low, p_deq

    # sr_requant: the chain's own inputs, then the other two weight shapes
    sr_rows = []
    shapes = [(2048, 2048), (5461, 2048), (2048, 5461), (2048, 32000)]
    for m, n in shapes:
        qt = probs[m, n][0] if (m, n) in probs else None
        if qt is not None:
            q, scale, update, u01 = sr_args[tuple(qt.q.shape)]
        else:
            qt = quant.quantize_blockwise(
                torch.randn((m, n), generator=gen, device=dev) * 0.02, 8,
                symmetric=True)
            q, scale = qt.q, qt.scale
            update = torch.randn(q.shape, generator=gen, device=dev) * 1e-5
            u01 = torch.rand(q.shape, generator=gen, device=dev)
        qk, sk = tsr.sr_requant(q, scale, update, u01)
        qw, sw = ref.sr_requant_ref(q, scale, update, u01, 256)
        same = torch.equal(qk, qw)
        s_rel = ((sk - sw).abs().max() / sw.abs().max()).item()
        w_err = (qk.float() * sk.repeat_interleave(256, dim=1)
                 - qw.float() * sw.repeat_interleave(256, dim=1)
                 ).abs().max().item()
        row = {"R": q.shape[0], "C": q.shape[1], "n_real": n,
               "on_path": (m, n) in probs,
               "ms": time_ms(lambda: tsr.sr_requant(q, scale, update, u01),
                             flush),
               "plain_ms": time_ms(lambda: ref.sr_requant_ref(
                   q, scale, update, u01, 256), flush),
               "library_ms": None, "codes_equal": same,
               "scale_rel_err": s_rel, "max_abs_err": w_err}
        row["bound_ms"], row["bound_by"] = kernel_bound(
            0, kprof.sr_requant_bytes(*q.shape))
        sr_rows.append(row)
        ok = same and s_rel <= 1e-6
        if not ok:
            failed.append(("sr_requant", row))
        log(f"  sr_requant R={row['R']} C={row['C']} ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f}"
            f" codes equal {same} scale rel {s_rel:.2e} "
            f"{'ok' if ok else 'FAIL'}")
    del probs, sr_args
    torch.cuda.empty_cache()

    # quantize_int8 of every llama-1b weight (24 layers x 7 + the head),
    # drawn one at a time, against core.quant.quantize_blockwise
    per_layer = [(2048, 2048)] * 4 + [(2048, 5461)] * 2 + [(5461, 2048)]
    weights = per_layer * layers + [(2048, 32000)]
    torch.cuda.synchronize()
    LAUNCHES.clear()
    mismatched = []
    for i, (K, N) in enumerate(weights):
        w = torch.randn((K, N), generator=gen, device=dev) * 0.02
        got = ops.quantize_int8(w)
        want_ = quant.quantize_blockwise(w, 8, symmetric=True)
        if not (torch.equal(got.q, want_.q)
                and torch.equal(got.scale, want_.scale)
                and got.orig_last == want_.orig_last):
            mismatched.append((i, K, N))
    torch.cuda.synchronize()
    quant_counts = {n: c for n, c in LAUNCHES.items() if c}
    log(f"  quantize_int8 of {len(weights)} llama-1b weights: launches "
        f"{quant_counts}; {len(mismatched)} differ from quantize_blockwise")
    if mismatched or quant_counts.get("blockwise_quant") != len(weights):
        failed.append(("quantize_int8", {"mismatched": mismatched,
                                         "launches": quant_counts}))
    bq_rows = []
    for K, N in sorted(set(weights)):
        w = torch.randn((K, N), generator=gen, device=dev) * 0.02
        x = torch.nn.functional.pad(w, (0, -N % 256))
        qk, sk = tbq.blockwise_quant(x)
        qw, sw = ref.blockwise_quant_ref(x, 256)
        same = torch.equal(qk, qw) and torch.equal(sk, sw)
        row = {"R": K, "C": x.shape[1], "n_real": N,
               "launches": weights.count((K, N)),
               "ms": time_ms(lambda: tbq.blockwise_quant(x), flush),
               "plain_ms": time_ms(lambda: ref.blockwise_quant_ref(x, 256),
                                   flush),
               "library_ms": None, "bit_exact": same, "max_abs_err": 0.0
               if same else float("nan")}
        row["bound_ms"], row["bound_by"] = kernel_bound(
            0, kprof.blockwise_quant_bytes(*x.shape))
        bq_rows.append(row)
        if not same:
            failed.append(("blockwise_quant", row))
        log(f"  blockwise_quant R={K} C={row['C']} ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f}"
            f" bit exact {same}")
        del w, x
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"phase 7 kernels disagree with their plain "
                             f"versions: {failed}")
    return {"chain_launches": chain_counts, "quant_launches": quant_counts,
            "int4_matmul": i4_rows, "chain": chain_rows,
            "sr_requant": sr_rows, "blockwise_quant": bq_rows}


def chain_vs_executor(tr, seed: int) -> dict:
    """One more step from ``tr``'s trained state on the same clipped
    low-rank gradients through ``transform.qgalore_transform`` (the fused
    kernel) and ``transform.qgalore_reference_chain`` (plain PyTorch
    stages), with the same uniforms: every tuned INT8 weight within one
    quantum (the executor's largest new scale of the leaf), the reference's
    statement of the two."""
    from repro_torch.core import qgalore, quant, transform
    from repro_torch.kernels import LAUNCHES
    from repro_torch.train import stack
    from repro_torch.train import step as step_lib
    params, opt = tr.state
    specs, rules = tr.specs, tr.rules
    keys = [k for k, _ in qgalore.flatten(params)]
    trees = qgalore.unflatten(keys, opt.proj)
    _, grads = stack.fused_value_and_grad(tr.bundle, params,
                                          tr.batches(tr.tcfg.steps), trees)
    grads, _ = transform.clip_by_global_norm(grads, tr.tcfg.grad_clip,
                                             specs=specs)
    draw = step_lib.generator_uniforms(seed + 99, "cuda")
    uni = lambda leaf, layer, shape: draw(0, leaf, layer, shape)
    lr = tr.tcfg.learning_rate
    LAUNCHES.clear()
    p_ex, _, _ = transform.qgalore_transform(rules, specs).update(
        grads, opt, params, lr=lr, uniforms=uni)
    torch.cuda.synchronize()
    n_ex = dict(LAUNCHES)
    LAUNCHES.clear()
    p_ch, _, _ = transform.qgalore_reference_chain(rules).update(
        grads, transform.chain_state(opt), params, lr=lr, uniforms=uni,
        specs=specs)
    torch.cuda.synchronize()
    n_ch = dict(LAUNCHES)
    n_units = sum(s.nbatch for s in specs if s.galore)
    equal = total = 0
    worst, worst_path = 0.0, None
    ok = n_ex.get("fused_qgalore_update", 0) == n_units and not any(
        n_ch.values())
    for (_, a), (_, b), spec in zip(qgalore.flatten(p_ex),
                                    qgalore.flatten(p_ch), specs):
        if spec.frozen or not isinstance(a, quant.QTensor):
            continue
        equal += int((a.q == b.q).sum())
        total += a.q.numel()
        quantum = a.scale.max().item()
        err = (quant.dequantize(a, torch.float32)
               - quant.dequantize(b, torch.float32)).abs().max().item()
        ok = ok and err <= quantum + 1e-6
        if err / quantum > worst:
            worst, worst_path = err / quantum, spec.path
    out = {"codes_equal": equal / total, "max_quanta": worst,
           "max_quanta_leaf": worst_path, "lr": lr,
           "executor_launches": n_ex, "chain_launches": n_ch, "ok": ok}
    log(f"  one step from the trained state, chain against executor (lr "
        f"{lr:g}): INT8 codes equal {out['codes_equal']:.6f} of {total}; "
        f"largest difference {worst:.4f} quanta ({worst_path}); executor "
        f"launches {n_ex}, chain launches {n_ch} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fine-tune: chain against executor: {out}")
    return out


def phase_finetune_cli(seed: int) -> dict:
    """Phase 9a: ``launch.finetune.main`` with its default flags (llama-60m
    at its published widths and depth, rank 8, the first layer frozen, 8
    steps of 4 x 32 tokens) on the card; then one step of the chain
    against the executor from the trained state."""
    import contextlib
    import io
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import finetune
    log("== phase 9a: the fine-tune CLI at llama-60m (8 layers, d 512, "
        "rank 8, 1 frozen layer, 8 steps of 4 x 32 tokens)")
    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    out = out_dir / "finetune_memory.json"
    trainers, cls = [], finetune.Trainer

    class Recording(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            trainers.append(self)

    finetune.Trainer = Recording
    text = io.StringIO()
    LAUNCHES.clear()
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(text):
            rc = finetune.main(["--out", str(out)])
    finally:
        finetune.Trainer = cls
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = dict(LAUNCHES)
    report = json.loads(out.read_text())
    log(f"  {text.getvalue().strip().splitlines()[-1]} ({wall:.2f} s)")
    log(f"  report: groups {report['groups']}, first loss "
        f"{report['first_loss']:.4f}, final loss {report['final_loss']:.4f}"
        f", SVDs {report['svd_used']}; launches {counts}")
    problems = []
    if rc != 0:
        problems.append(f"main returned {rc}")
    if report["qgalore_leq_qlora"] is not True:
        problems.append("qgalore_leq_qlora is not true")
    missing = [n for n in TRAIN_KERNELS if not counts.get(n)]
    plain = {n: counts[n] for n in PLAIN_NAMES if counts.get(n)}
    if missing:
        problems.append(f"kernels not launched: {missing}")
    if plain:
        problems.append(f"plain versions ran on the card: {plain}")
    if problems:
        raise AssertionError("fine-tune CLI: " + "; ".join(problems))
    chain = chain_vs_executor(trainers[0], seed)
    del trainers
    torch.cuda.empty_cache()
    return {"report": report, "wall_s": wall, "launches": counts,
            "chain_vs_executor": chain}


FT_7B_STEPS = 4           # steps 0 and 2 refresh at update_interval 2
FT_7B_RANK = 8


def phase_finetune_7b(seed: int) -> dict:
    """Phase 9b: LLaMA-7B fine-tuning at full width and depth, split after
    the first layer, under ``launch.finetune``'s rule-set at rank 8 (the
    randomized subspace method), 8 x 256 tokens a step, 4 steps. The four
    contracts through ``launch.finetune``'s functions, the steps, memory
    and launches, then every distinct kernel problem against its plain
    version (phase 8's checks)."""
    from repro_torch.config import QGaLoreConfig, ShapeCell, TrainConfig
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import finetune
    from repro_torch.models import model_zoo
    from repro_torch.train.trainer import Trainer
    log(f"== phase 9b: LLaMA-7B fine-tuning (32 layers, layer 0 and the "
        f"embedding, final norm and head frozen, rank {FT_7B_RANK}, "
        f"randomized subspace, 8 x 256 tokens)")
    cfg = model_zoo.get_config("llama-7b")
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16,
                             split_layers=1)
    rules = finetune.build_finetune_rules(
        QGaLoreConfig(rank=FT_7B_RANK, min_dim=128, update_interval=2,
                      subspace_method="randomized"), FT_7B_RANK)
    tcfg = TrainConfig(seed=seed, global_batch=8, seq_len=256,
                       steps=FT_7B_STEPS, learning_rate=1e-3,
                       warmup_steps=max(FT_7B_STEPS // 10, 1), grad_clip=1.0,
                       log_every=0)
    card = nvidia_smi_line()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.monotonic()
    tr = Trainer(bundle, tcfg, rules, param_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    specs = tr.specs
    frozen = finetune.check_frozen_stateless(specs, tr.state.opt)
    finetune.check_group_ranks(specs, FT_7B_RANK)
    frozen_before = finetune.frozen_weights(tr.state.params, specs)
    n_units = sum(s.nbatch for s in specs if s.galore)
    log(f"  init on the card: {init_s:.2f} s; {len(frozen)} frozen leaves, "
        f"{n_units} tuned GaLore units; device memory before the phase "
        f"{before:.2f} GiB")

    rec = ProblemRecorder()
    peaks = {}

    def at_step(step):
        peaks[step - 1] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        rec.step = step

    LAUNCHES.clear()
    with rec:
        rows = run_counted(tr, tcfg.steps, TRAIN_KERNELS + PLAIN_NAMES,
                           at_step)
    counts = dict(LAUNCHES)
    peaks[tcfg.steps - 1] = torch.cuda.max_memory_allocated() / 2 ** 30
    finetune.check_frozen_unchanged(frozen_before, tr.state.params, specs)
    del frozen_before
    mem = finetune.memory_vs_qlora(tr.state.params, rules, FT_7B_RANK,
                                   specs=specs)
    finetune.check_memory_leq_qlora(mem, FT_7B_RANK)
    refresh = sorted(s for s in rec.sub_s if s >= 0)
    steady = [r for r in rows if r["step"] not in refresh]
    micro = 7 * cfg.num_layers + 1           # dense calls a forward
    want_steady = {"int8_matmul": 2 * micro - 1, "int8_matmul_t": micro,
                   "fused_qgalore_update": n_units}
    if not refresh or refresh[0] != 0 or not steady:
        raise AssertionError(f"fine-tune 7b: refresh steps {refresh}, want "
                             "step 0 and at least one steady step")
    problems = []
    for r in rows:
        want = dict(want_steady, **({"fused_qgalore_update": 0}
                                    if r["step"] in refresh else {}))
        got = {n: r["launches"][n] for n in want}
        if got != want:
            problems.append(f"step {r['step']} launches {got} != {want}")
        plain = {n: r["launches"][n] for n in PLAIN_NAMES
                 if r["launches"][n]}
        if plain:
            problems.append(f"step {r['step']} ran plain versions {plain}")
        if not np.isfinite(r["loss"]):
            problems.append(f"step {r['step']} loss {r['loss']}")
    steady_s = [r["s"] for r in steady]
    tokens = tcfg.global_batch * tcfg.seq_len
    steady_peak = max(peaks[r["step"]] for r in steady)
    result = {
        "steps": tcfg.steps, "rank": FT_7B_RANK, "split_layers": 1,
        "subspace_method": "randomized", "update_interval": 2,
        "tuned_units": n_units, "frozen_leaves": len(frozen),
        "init_s": init_s, "losses": [r["loss"] for r in rows],
        "refresh_steps": refresh,
        "refresh_step_s": {str(r["step"]): r["s"] for r in rows
                           if r["step"] in refresh},
        "refresh_subspace_s": {str(s): rec.sub_s[s] for s in refresh},
        "median_steady_step_ms": statistics.median(steady_s) * 1e3,
        "tokens_per_s": tokens / statistics.median(steady_s),
        "steady_peak_gib": steady_peak, "phase_peak_gib": max(peaks.values()),
        "peak_gib_by_step": {str(k): v for k, v in sorted(peaks.items())},
        "held_before_phase_gib": before, "memory": mem, "card": card,
        "launches": counts,
        "launches_per_steady_step": steady[-1]["launches"]}
    log(f"  losses {[round(x, 4) for x in result['losses']]}; refresh "
        f"steps {refresh}: " + ", ".join(
            f"step {s} {result['refresh_step_s'][str(s)]:.2f} s (subspace "
            f"{rec.sub_s[s]:.2f} s)" for s in refresh)
        + f"; median steady step {result['median_steady_step_ms']:.1f} ms "
        f"-> {result['tokens_per_s']:.1f} tokens/s [{card}]")
    log(f"  measured launches per steady step: "
        f"{result['launches_per_steady_step']} (want {want_steady}) "
        f"[{card}]")
    result["roofline"] = step_roofline(
        "9b", cfg, ShapeCell("train", tcfg.seq_len, tcfg.global_batch,
                             "train"), result["median_steady_step_ms"],
        rank=FT_7B_RANK)
    log("  max_memory_allocated by step (GiB; -1: the init): "
        + ", ".join(f"{s}: {v:.2f}" for s, v in sorted(peaks.items()))
        + f"; steady peak {steady_peak:.2f}, phase peak "
        f"{result['phase_peak_gib']:.2f} [{card}]")
    log(f"  memory_report (GiB): Q-GaLore weights "
        f"{mem['qgalore']['weights_gb']:.4f} + optimizer "
        f"{mem['qgalore']['optimizer_gb']:.4f} = "
        f"{mem['qgalore']['total_gb']:.4f}; QLoRA at rank {FT_7B_RANK}: "
        f"weights {mem['qlora']['weights_gb']:.4f} + adapters and moments "
        f"{mem['qlora']['adapter_plus_opt_gb']:.4f} = "
        f"{mem['qlora']['total_gb']:.4f}; the four contracts hold "
        f"[{card}]")
    if problems:
        raise AssertionError("fine-tune 7b: " + "; ".join(problems))
    del tr
    torch.cuda.empty_cache()
    log(f"  the phase's kernel problems against their plain versions, on "
        f"[{card}]:")
    result.update(rec.check(tcfg.steps, len(steady), seed))
    return result


PAGED_BLOCK, PAGED_CHUNK = 16, 32
SYSTEM_PROMPT = 256       # phase 10a's shared prefix, 16 blocks


def pool_bytes_slot(bundle, slots: int, window: int) -> int:
    """The bytes of the slot scheduler's bf16 pool (``init_pool``): each
    leaf in its own dtype where the segment names one (a recurrent
    state's float32)."""
    return sum(seg.n_layers * math.prod(shape)
               * torch.empty((), dtype=dt or torch.bfloat16).element_size()
               for seg in bundle.segments
               for shape, dt in seg.cache_shapes(slots, window))


def first_divergence(got: dict, want: dict):
    """The share of requests whose tokens equal ``want``'s, and the first
    (rid, token index) where they differ (None if all are equal)."""
    same = [r for r in want if got.get(r) == want[r]]
    for r in sorted(want):
        if got.get(r) != want[r]:
            a, b = got.get(r, []), want[r]
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            return len(same) / len(want), (r, i)
    return 1.0, None


def paged_run(bundle, params, reqs, *, slots: int, window: int,
              shapes: set, num_blocks=None, profile: bool = False,
              per_call: int = 0, per_call_t: int = 0, sched_kw=None,
              comm=None, roofline: bool = True) -> dict:
    """One run of ``reqs`` through ``make_scheduler(backend="auto")`` (the
    paged scheduler) on the card, bf16: every dispatch counted and timed
    (synchronised), its launches held to ``per_call`` of ``int8_matmul``
    (default llama-1b's 169) and ``per_call_t`` of ``int8_matmul_t`` a
    decode or append dispatch and twice those a fused one, the allocator's
    invariant after the run. With ``profile``, five decode-only steps
    with every slot in flight are then profiled as phase 3's are (prompts
    cut to one chunk, so the first step prefills them all). ``sched_kw``
    goes to the scheduler (phase 19: ``shardings``, ``group``); with
    ``comm`` each dispatch's collectives on it (calls, bytes, seconds by
    op) are kept by dispatch kind; ``roofline`` False prints no roofline
    line (a rank's share of a split model)."""
    from repro_torch.config import ShapeCell
    from repro_torch.kernels import LAUNCHES
    from repro_torch.serve.paged import PagedScheduler
    from repro_torch.serve.scheduler import Request, make_scheduler
    per_call = per_call or 7 * num_layers() + 1
    sched = make_scheduler(bundle, params, backend="auto", num_slots=slots,
                           max_len=window, block_size=PAGED_BLOCK,
                           num_blocks=num_blocks, prefill_chunk=PAGED_CHUNK,
                           dtype=torch.bfloat16, device="cuda",
                           **(sched_kw or {}))
    if type(sched) is not PagedScheduler:
        raise AssertionError(f"backend auto gave {type(sched).__name__}")
    # warm-up: first launches of the append and decode programs
    sched.run([Request(rid=-1, tokens=reqs[0].tokens[:PAGED_CHUNK + 1],
                       max_new_tokens=2)])
    sched.reset()
    ms = {"_step": [], "_append": [], "_fused": []}
    got_by = {n: [] for n in ms}
    coll_by = {n: [] for n in ms}
    bad = []

    def timed(name, inner):
        mult = 2 if name == "_fused" else 1
        want = (per_call * mult, per_call_t * mult)

        def run(*a):
            before = (LAUNCHES["int8_matmul"], LAUNCHES["int8_matmul_t"])
            if comm is not None:
                comm.reset_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inner(*a)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t) * 1e3)
            if comm is not None:
                coll_by[name].append({k: list(v) for k, v in
                                      comm.stats.items()})
            got = (LAUNCHES["int8_matmul"] - before[0],
                   LAUNCHES["int8_matmul_t"] - before[1])
            got_by[name].append(got)
            if got != want:
                bad.append((name, got))
            return out
        return run

    inner = {n: getattr(sched, n) for n in ms}
    for n in ms:
        setattr(sched, n, timed(n, inner[n]))
    from repro_torch.kernels import int8_matmul as ti8
    kernel = ti8.int8_matmul

    def recording(x, q, scale, block=256):
        shapes.add((x.shape[0], q.shape[0], q.shape[1], x.dtype))
        return kernel(x, q, scale, block)

    from repro_torch.kernels import ops as kops
    dense_t = kops.quantized_dense_t
    head_calls = [0]

    def counted_dense_t(*a, **kw):
        head_calls[0] += 1
        return dense_t(*a, **kw)

    ti8.int8_matmul = recording
    kops.quantized_dense_t = counted_dense_t
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.monotonic()
    try:
        comps = sched.run(reqs)
        torch.cuda.synchronize()
    finally:
        ti8.int8_matmul = kernel
        kops.quantized_dense_t = dense_t
        for n in ms:
            setattr(sched, n, inner[n])
    wall = time.monotonic() - t0
    counts, st = dict(LAUNCHES), dict(sched.stats)
    problems = [f"{n} dispatch launched (int8_matmul, int8_matmul_t) {k}"
                f" times" for n, k in bad[:3]]
    n_disp = {n: len(v) for n, v in ms.items()}
    calls = n_disp["_step"] + n_disp["_append"] + 2 * n_disp["_fused"]
    # measured: the launches each decode dispatch counted, and the
    # int8_matmul_t launches of the run over its tied-head calls
    per_decode = {k: sum(g[i] for g in got_by["_step"]) / len(got_by["_step"])
                  for i, k in enumerate(("int8_matmul", "int8_matmul_t"))} \
        if got_by["_step"] else None
    per_head = counts.get("int8_matmul_t", 0) / head_calls[0] \
        if head_calls[0] else None
    if counts.get("int8_matmul") != per_call * calls or \
            counts.get("int8_matmul_t", 0) != per_call_t * calls:
        problems.append(f"launches {counts} != {per_call} int8_matmul and "
                        f"{per_call_t} int8_matmul_t x {calls} for "
                        f"dispatches {n_disp}")
    if any(n.endswith("_ref") or n.startswith("deq_")
           or n.startswith("flash") for n in counts):
        problems.append(f"plain versions or flash ran: {counts}")
    by_rid = {c.rid: c for c in comps}
    for r in reqs:
        c = by_rid.get(r.rid)
        if c is None or len(c.tokens) != r.max_new_tokens:
            problems.append(f"request {r.rid} incomplete")
    if st["admitted"] < len(reqs) or st["retired"] != len(reqs):
        problems.append(f"admitted/retired {st['admitted']}/"
                        f"{st['retired']}")
    sched.alloc.check()
    held = len(sched.radix.cached_blocks())
    leaked = sched.alloc.usable_blocks - held - sched.alloc.free_blocks
    if leaked:
        problems.append(f"{leaked} blocks leaked")
    n_tok = sum(len(c.tokens) for c in comps)
    prof = profile_decode(sched_stepper(sched, [
        Request(rid=r.rid, tokens=r.tokens[:PAGED_CHUNK],
                max_new_tokens=SERVE_MAX_NEW) for r in reqs[:slots]])) \
        if profile else {}
    out = {"slots": slots, "window": window, **prof,
           "num_blocks": sched.num_blocks, "pool_bytes": sched.pool_bytes(),
           "tokens_per_s": n_tok / wall, "wall_s": wall, "tokens": n_tok,
           "mean_ttft_s": float(np.mean([c.ttft for c in comps])),
           "median_decode_step_ms": statistics.median(ms["_step"])
           if ms["_step"] else None,
           "median_fused_ms": statistics.median(ms["_fused"])
           if ms["_fused"] else None,
           "median_append_ms": statistics.median(ms["_append"])
           if ms["_append"] else None,
           "dispatches": n_disp, "launches": counts,
           "collectives_by_dispatch": coll_by if comm is not None else None,
           "launches_per_decode_dispatch": per_decode,
           "head_calls": head_calls[0],
           "launches_per_head_call": per_head,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "stats": st, "tokens_by_rid": {c.rid: c.tokens for c in comps}}
    log(f"  paged, {slots} slots, window {window}, {sched.num_blocks} "
        f"blocks ({out['pool_bytes'] / 2**20:.1f} MiB): {n_tok} tokens in "
        f"{wall:.2f} s -> {out['tokens_per_s']:.1f} tok/s; mean TTFT "
        f"{out['mean_ttft_s']:.3f} s; median ms decode "
        f"{out['median_decode_step_ms']} fused {out['median_fused_ms']} "
        f"append {out['median_append_ms']}; dispatches {n_disp}; peak "
        f"{out['peak_gib']:.2f} GiB; stats {st}; launches {counts}")
    del sched
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("paged serving: " + "; ".join(problems))
    if out["median_decode_step_ms"] and roofline:
        out["roofline"] = step_roofline(
            f"paged {slots} slots", bundle.cfg,
            ShapeCell("serve", max(len(r.tokens) for r in reqs), slots,
                      "decode"), out["median_decode_step_ms"],
            tokens_per_s=out["tokens_per_s"],
            device_ms=prof.get("profile_step_device_ms"))
    return out


def slot_run(bundle, params, reqs, *, window: int) -> dict:
    """The same traffic through the slot scheduler (8 slots), for the
    shared-prefix comparison: tokens/s and mean TTFT."""
    from repro_torch.serve.scheduler import Request, Scheduler
    sched = Scheduler(bundle, params, num_slots=SERVE_SLOTS, max_len=window,
                      dtype=torch.bfloat16, device="cuda")
    sched.run([Request(rid=-1, tokens=reqs[0].tokens[:16],
                       max_new_tokens=2)])
    sched.reset()
    t0 = time.monotonic()
    comps = sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n_tok = sum(len(c.tokens) for c in comps)
    out = {"tokens_per_s": n_tok / wall, "wall_s": wall,
           "mean_ttft_s": float(np.mean([c.ttft for c in comps])),
           "tokens_by_rid": {c.rid: c.tokens for c in comps}}
    log(f"  slot, {SERVE_SLOTS} slots, window {window}: {n_tok} tokens in "
        f"{wall:.2f} s -> {out['tokens_per_s']:.1f} tok/s; mean TTFT "
        f"{out['mean_ttft_s']:.3f} s")
    del sched
    torch.cuda.empty_cache()
    return out


def phase_paged(seed: int, serving: dict) -> dict:
    """Phase 10a: llama-1b at full width and depth through the paged
    scheduler, beside phase 3's slot run (``serving``)."""
    from repro_torch.serve.scheduler import Request
    log("== phase 10a: llama-1b serving through the paged scheduler "
        f"(block {PAGED_BLOCK}, chunk {PAGED_CHUNK})")
    log("card:", nvidia_smi_line())
    cfg, bundle, params = serving_model(seed)
    reqs = serving_requests(seed, cfg.vocab_size)
    shapes: set = set()
    runs = {"paged_8": paged_run(bundle, params, reqs, slots=SERVE_SLOTS,
                                 window=SERVE_WINDOW, shapes=shapes,
                                 profile=True)}
    system = np.random.default_rng(seed + 10).integers(
        1, cfg.vocab_size, size=SYSTEM_PROMPT).astype(np.int32)
    shared = [Request(rid=r.rid, tokens=np.concatenate([system, r.tokens]),
                      max_new_tokens=r.max_new_tokens) for r in reqs]
    wide = SERVE_WINDOW + SYSTEM_PROMPT
    runs["shared_slot"] = slot_run(bundle, params, shared, window=wide)
    runs["shared_paged"] = paged_run(bundle, params, shared,
                                     slots=SERVE_SLOTS, window=wide,
                                     shapes=shapes)
    blocks_8 = runs["paged_8"]["num_blocks"]
    runs["paged_16"] = paged_run(bundle, params, reqs, slots=2 * SERVE_SLOTS,
                                 window=SERVE_WINDOW, shapes=shapes,
                                 num_blocks=blocks_8)
    slot_bytes = pool_bytes_slot(bundle, SERVE_SLOTS, SERVE_WINDOW)
    problems = []
    if not runs["shared_paged"]["stats"]["radix_hit_blocks"]:
        problems.append("no radix hits behind the shared system prompt")
    p16 = runs["paged_16"]
    if p16["stats"]["max_concurrent"] <= SERVE_SLOTS:
        problems.append(f"16 slots ran at most "
                        f"{p16['stats']['max_concurrent']} requests")
    # the scratch block: one block over the slot pool's 8 x MB
    limit = slot_bytes * (1 + 1 / (SERVE_SLOTS
                                   * -(-SERVE_WINDOW // PAGED_BLOCK)))
    if p16["pool_bytes"] > limit:
        problems.append(f"pool {p16['pool_bytes']} B > {limit:.0f} B")
    equal = {}
    for name, want in (("paged_8", serving["tokens_by_rid"]),
                       ("paged_16", serving["tokens_by_rid"]),
                       ("shared_paged", runs["shared_slot"][
                           "tokens_by_rid"])):
        equal[name] = first_divergence(runs[name]["tokens_by_rid"], want)
    log(f"  slot pool {slot_bytes / 2**20:.1f} MiB; paged pool at 16 slots "
        f"{p16['pool_bytes'] / 2**20:.1f} MiB, max concurrent "
        f"{p16['stats']['max_concurrent']}")
    for name, (share, div) in equal.items():
        log(f"  {name}: share of requests with the slot run's greedy "
            f"tokens {share:.4f}, first divergence (rid, index) {div}")
    s3, p8 = serving, runs["paged_8"]
    log(f"  beside phase 3 (slot, 8 slots; {nvidia_smi_line()}): tok/s "
        f"{s3['tokens_per_s']:.1f} / paged {p8['tokens_per_s']:.1f}; mean "
        f"TTFT {s3['mean_ttft_s']:.3f} / {p8['mean_ttft_s']:.3f} s; median "
        f"decode step {s3['median_decode_step_ms']:.2f} / "
        f"{p8['median_decode_step_ms']:.2f} ms; peak {s3['peak_gib']:.2f} /"
        f" {p8['peak_gib']:.2f} GiB; shared prefix: slot TTFT "
        f"{runs['shared_slot']['mean_ttft_s']:.3f} s / paged "
        f"{runs['shared_paged']['mean_ttft_s']:.3f} s")
    if problems:
        raise AssertionError("paged serving: " + "; ".join(problems))
    del params, bundle
    torch.cuda.empty_cache()
    check = check_shapes(shapes, seed)
    paths = {small_m(M, K, N) for M, K, N, _ in shapes}
    if paths != {True, False}:
        raise AssertionError(f"paged serving ran one int8_matmul path only "
                             f"(small-M: {paths})")
    return {"runs": {n: {k: v for k, v in r.items() if k != "tokens_by_rid"}
                     for n, r in runs.items()},
            "slot_pool_bytes": slot_bytes,
            "equal_to_slot": {n: {"share": sh, "first_divergence": d}
                              for n, (sh, d) in equal.items()},
            "launches": sum(r["launches"].get("int8_matmul", 0)
                            for r in runs.values() if "launches" in r),
            **check}


PARITY_TOL = 1e-4     # f32: the kernels take two passes


def phase_paged_parity(seed: int) -> dict:
    """Phase 10b: llama-1b widths at 2 layers, f32, the same INT8 codes on
    the card and the CPU: chunked append against one-shot prefill on the
    card; the paged scheduler on the card against the CPU's and against
    the card's slot scheduler."""
    from repro_torch.config import replace
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import model_zoo
    from repro_torch.serve import engine
    from repro_torch.serve.params import quantize_leaf
    from repro_torch.serve.scheduler import Request, Scheduler, \
        init_pool, make_scheduler
    log("== phase 10b: paged parity at f32, llama-1b widths at 2 layers")
    cfg = replace(model_zoo.get_config("llama-1b"), num_layers=2)
    bundles = {dev: model_zoo.build(cfg, device=dev, dtype=torch.float32)
               for dev in ("cpu", "cuda")}
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    p_gpu = bundles["cuda"].init_params(
        gen, leaf_fn=lambda _, t: quantize_leaf(t))
    params = {"cuda": p_gpu, "cpu": to_cpu(p_gpu)}
    rng = np.random.default_rng(seed + 3)
    P, window = 100, 128
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(1, P))
                              .astype(np.int32)).cuda()
    b, p = bundles["cuda"], params["cuda"]
    want_l, want = engine.build_prefill(b, window)(p, {"tokens": prompt})
    append = engine.build_append(b, window)
    widths, problems = {}, []
    for c in (1, 5, 16, 48):
        state = init_pool(b, 1, window, torch.float32, "cuda")
        for pos in range(0, P, c):
            n = min(c, P - pos)
            chunk = torch.zeros((1, c), dtype=torch.int32, device="cuda")
            chunk[0, :n] = prompt[0, pos:pos + n]
            logits, state = append(p, state, chunk, torch.tensor(
                [n], dtype=torch.int32, device="cuda"))
        rel_l = ((logits - want_l).abs().max()
                 / want_l.abs().max()).item()
        rel_c = max(((g[:, :, :P] - r[:, :, :P]).abs().max()
                     / r[:, :, :P].abs().max()).item()
                    for g, r in zip(state.caches["seg0_dense"],
                                    want.caches["seg0_dense"]))
        widths[c] = {"logits_rel": rel_l, "cache_rel": rel_c}
        if max(rel_l, rel_c) > PARITY_TOL:
            problems.append(f"append width {c}: {widths[c]}")
    log(f"  build_append against one-shot prefill on the card: {widths}")
    prefix = rng.integers(1, cfg.vocab_size, size=48)
    reqs = []
    for i in range(8):
        t = rng.integers(1, cfg.vocab_size, size=int(rng.integers(3, 20)))
        if i % 2 == 0:
            t = np.concatenate([prefix, t])
        reqs.append((i, t.astype(np.int32).tolist(),
                     int(rng.integers(2, 8))))
    runs = {}
    for name, dev, backend in (("paged_cpu", "cpu", "paged"),
                               ("paged_card", "cuda", "paged"),
                               ("slot_card", "cuda", "slot")):
        sched = make_scheduler(bundles[dev], params[dev], backend=backend,
                               num_slots=4, max_len=window,
                               block_size=PAGED_BLOCK,
                               prefill_chunk=PAGED_CHUNK,
                               dtype=torch.float32, device=dev)
        LAUNCHES.clear()
        t0 = time.monotonic()
        comps = sched.run([Request(*r) for r in reqs])
        runs[name] = ({c.rid: c.tokens for c in comps}, dict(sched.stats),
                      dict(LAUNCHES), time.monotonic() - t0)
        if backend == "paged":
            sched.alloc.check()
        del sched
    (t_c, s_c, n_c, w_c), (t_g, s_g, n_g, w_g), (t_s, _, _, _) = (
        runs["paged_cpu"], runs["paged_card"], runs["slot_card"])
    log(f"  paged scheduler, card {w_g:.2f} s / CPU {w_c:.2f} s: tokens "
        f"equal {t_g == t_c}, stats equal {s_g == s_c} ({s_g}); card's "
        f"slot scheduler tokens equal {t_g == t_s}; launches card {n_g} "
        f"CPU {n_c}")
    if not n_g.get("int8_matmul") or any(n.endswith("_ref")
                                         or n.startswith("deq_")
                                         for n in n_g):
        problems.append(f"card run did not go through the kernel: {n_g}")
    if not n_c.get("deq_matmul") or n_c.get("int8_matmul"):
        problems.append(f"CPU run did not take the plain path: {n_c}")
    if t_g != t_c or s_g != s_c:
        problems.append(f"card against CPU: tokens {t_g} vs {t_c}, stats "
                        f"{s_g} vs {s_c}")
    if t_g != t_s:
        problems.append(f"paged against slot: tokens {t_g} vs {t_s}")
    if not s_g["radix_hit_blocks"]:
        problems.append("no radix hits")
    if problems:
        raise AssertionError("paged parity: " + "; ".join(problems))
    return {"append_vs_prefill": widths, "stats": s_g,
            "tokens_equal_cpu": True, "tokens_equal_slot": True}


DENSE_ARCHS = ("mistral-nemo-12b", "yi-9b", "qwen3-32b", "gemma-7b",
               "internvl2-2b")
# the depth of the full-width runs of phases 11a, 12a and 15a/15c/15d,
# every width as published: these runs are host-bound, so
# their time follows the layer count, and at full depth the script came
# within a few percent of its time limit on a fast host and past it on a
# slow one. Every launch check counts per layer; 11b-13b's f32 parity and
# the kernel rows are not cut. Phase 14 stays at full depth: at one group
# of xlstm-125m's two, 14a's bf16 decode against the forward read 0.115
# of max|logits| at one step, over its 0.1 bar (0.093 at full depth).
SERVE_DEPTH = {"mistral-nemo-12b": 8, "yi-9b": 8, "qwen3-32b": 8,
               "gemma-7b": 8, "internvl2-2b": 8, "qwen3-moe-30b-a3b": 12,
               "zamba2-2.7b": 18}


def served_config(arch: str):
    """``arch``'s published config at ``SERVE_DEPTH``'s depth."""
    from repro_torch.config import replace
    from repro_torch.models import model_zoo
    return replace(model_zoo.get_config(arch),
                   num_layers=SERVE_DEPTH[arch])


def depth_cut(arch: str) -> str:
    """How ``served_config`` cuts ``arch``, as printed."""
    from repro_torch.models import model_zoo
    return (f"{arch} at {SERVE_DEPTH[arch]} of "
            f"{model_zoo.get_config(arch).num_layers} layers")
DENSE_SLOTS, DENSE_REQS, DENSE_NEW = 4, 8, 16
DENSE_PROMPT = (64, 512)
DENSE_WINDOW = DENSE_PROMPT[1] + DENSE_NEW
# bf16 teacher-forced decode against the full forward: the two paths round
# at different places (a decode matmul at M = 1 takes the small-M path's
# two passes, the forward's M = 32 the tiled path's one bf16 pass, 2e-2 of
# max|plain| a matmul at most, docs/kernels.md), and every layer casts its
# output to bf16 (2^-9 relative); over 24-64 layers of random weights the
# logits may differ by a few hundredths of max|logits|. A wrong cache
# position, RoPE angle or missing qk-norm moves them by O(1), ten times
# this bar or more.
BF16_PATH_TOL = 0.1
# a decode row alone against the same row among DENSE_SLOTS at f32, from
# the same prefill state (of max|logits|): rounding moves it by ~1e-6, a
# row or slot mixed up by O(1)
BATCH_ROW_TOL = 1e-3
TIED_MS = (1, 8, 16, DENSE_SLOTS * DENSE_PROMPT[1])


def dense_requests(seed: int, vocab: int) -> list:
    """Phase 11a's 8 requests: prompts of 64-512 tokens drawn from
    ``seed``, 16 greedy new tokens each."""
    from repro_torch.serve.scheduler import Request
    rng = np.random.default_rng(seed + 11)
    lens = rng.integers(DENSE_PROMPT[0], DENSE_PROMPT[1] + 1,
                        size=DENSE_REQS)
    return [Request(rid=i, tokens=rng.integers(1, vocab, size=int(n))
                    .astype(np.int32), max_new_tokens=DENSE_NEW)
            for i, n in enumerate(lens)]


def tree_stats(params) -> dict:
    """Parameters of a tree, and the bytes of its INT8 leaves (codes and
    scales) and of its float leaves."""
    from repro_torch.core.quant import QTensor
    out = {"params": 0, "int8_bytes": 0, "float_bytes": 0}

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, QTensor):
            out["params"] += math.prod(t.shape)
            out["int8_bytes"] += t.q.nbytes + t.scale.nbytes
        else:
            out["params"] += t.numel()
            out["float_bytes"] += t.nbytes
    walk(params)
    return out


def decode_vs_forward(bundle, params, seed: int, prompt: int = 32,
                      steps: int = 4) -> list:
    """Phase 11b at bf16: one prompt's prefill, then teacher-forced decode
    steps through the cache, each step's logits against the full-sequence
    forward's last logits at that length (relative to max|forward|)."""
    from repro_torch.models import base
    from repro_torch.serve import engine
    rng = np.random.default_rng(seed + 12)
    toks = torch.from_numpy(rng.integers(
        1, bundle.cfg.vocab_size, size=(1, prompt + steps))
        .astype(np.int32)).cuda()

    @torch.no_grad()
    def full(upto):
        carry, ctx = bundle.embed(params, {"tokens": toks[:, :upto]})
        carry = base.run_segments(bundle, params, carry, ctx)
        return bundle.head_logits(params, carry)[:, -1].float()

    def rel(a, b):
        return ((a.float() - b).abs().max() / b.abs().max()).item()

    logits, state = engine.build_prefill(bundle, prompt + steps + 1)(
        params, {"tokens": toks[:, :prompt]})
    errs = [rel(logits[:, -1], full(prompt))]
    decode = engine.build_decode(bundle)
    for t in range(prompt, prompt + steps):
        logits, state = decode(params, state, toks[:, t: t + 1])
        errs.append(rel(logits[:, -1], full(t + 1)))
    return errs


def serve_dense(arch: str, seed: int) -> dict:
    """Phase 11a (and 11b's bf16 half) for one architecture at full width
    and depth: weights drawn and quantized on the card one layer of a
    group at a time, 8 requests through ``make_scheduler`` (the paged
    runtime), every dispatch's launches held to the architecture's count;
    then the decode-against-forward check and every distinct
    ``int8_matmul`` problem against its plain version."""
    from repro_torch.models import model_zoo
    from repro_torch.serve.params import quantize_leaf
    cfg = served_config(arch)
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = bundle.init_params(gen, leaf_fn=lambda _, t: quantize_leaf(t),
                                by_layer=True)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = tree_stats(params)
    want_params = model_zoo.count_params(cfg)
    tied = cfg.tie_embeddings
    per_call = 7 * cfg.num_layers + (0 if tied else 1)
    per_call_t = 1 if tied else 0
    log(f"  {arch}: {cfg.num_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} x {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.ffn_activation}"
        f"{', qk-norm' if cfg.qk_norm else ''}"
        f"{', tied head' if tied else ''}"
        f"{', vlm' if cfg.family == 'vlm' else ''}: {st['params'] / 1e9:.2f} "
        f"B parameters ({want_params / 1e9:.2f} B counted on the meta "
        f"device), INT8 codes and scales {st['int8_bytes'] / 2**30:.2f} GiB, "
        f"float {st['float_bytes'] / 2**20:.2f} MiB; drawn and quantized in "
        f"{init_s:.2f} s, peak {init_peak:.2f} GiB")
    problems = []
    if st["params"] != want_params:
        problems.append(f"{st['params']} parameters drawn, "
                        f"{want_params} counted")
    shapes: set = set()
    run = paged_run(bundle, params, dense_requests(seed, cfg.vocab_size),
                    slots=DENSE_SLOTS, window=DENSE_WINDOW, shapes=shapes,
                    profile=True, per_call=per_call, per_call_t=per_call_t)
    if tied and run["launches_per_head_call"] != 1:
        problems.append(f"{run['launches']} launches over "
                        f"{run['head_calls']} tied-head calls")
    if not tied and run["head_calls"]:
        problems.append(f"{run['head_calls']} tied-head calls, untied head")
    errs = decode_vs_forward(bundle, params, seed)
    log(f"  {arch} bf16 decode against the full forward (prefill, then 4 "
        f"teacher-forced steps), rel err {['%.2e' % e for e in errs]} "
        f"(tolerance {BF16_PATH_TOL})")
    if max(errs) > BF16_PATH_TOL:
        problems.append(f"decode against forward {errs}")
    del params, bundle
    gc.collect()
    torch.cuda.empty_cache()
    check = check_shapes(shapes, seed)
    if problems:
        raise AssertionError(f"phase 11a {arch}: " + "; ".join(problems))
    out = {k: run.get(k) for k in (
        "tokens_per_s", "mean_ttft_s", "median_decode_step_ms",
        "median_append_ms", "median_fused_ms", "dispatches", "launches",
        "peak_gib", "stats", "wall_s", "profile_step_wall_ms",
        "profile_step_device_ms", "device_idle_share", "profile_error",
        "launches_per_decode_dispatch", "head_calls",
        "launches_per_head_call")}
    out.update(layers=cfg.num_layers, params=st["params"],
               int8_gib=st["int8_bytes"] / 2 ** 30, init_s=init_s,
               init_peak_gib=init_peak, decode_vs_forward_rel=errs,
               **check)
    return out


def f32_parity_dense(arch: str, seed: int, cfg=None, prompt: int = 12,
                     tol: float = PARITY_TOL) -> dict:
    """Phase 11b (and 12b, 13b, 14b) at f32: 2 layers at full width (or
    ``cfg``), the same INT8 codes on the card and the CPU; a prefill of
    ``prompt`` tokens and 3 teacher-forced decode steps (and for the VLM
    the full forward over a patch prefix), the card's logits within
    ``tol`` (``PARITY_TOL``) of the CPU's and the same greedy token at
    each; the card launches the kernels (an MoE model the batched one
    too), the CPU the plain versions."""
    from repro_torch.config import replace
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import base, model_zoo
    from repro_torch.serve import engine
    from repro_torch.serve.params import quantize_leaf
    cfg = cfg or replace(model_zoo.get_config(arch), num_layers=2)
    gpu = model_zoo.build(cfg, device="cuda", dtype=torch.float32)
    cpu = model_zoo.build(cfg, device="cpu", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    p_gpu = gpu.init_params(gen, leaf_fn=lambda _, t: quantize_leaf(t),
                            by_layer=True)
    p_cpu = to_cpu(p_gpu)
    rng = np.random.default_rng(seed + 13)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                         size=(1, prompt + 3))
                            .astype(np.int32))
    patches = torch.from_numpy(rng.standard_normal(
        (1, cfg.num_prefix_embeddings, cfg.d_model)).astype(np.float32)) \
        * 0.5 if cfg.family == "vlm" else None
    out = {}
    for name, bundle, params in (("cpu", cpu, p_cpu), ("gpu", gpu, p_gpu)):
        dev = bundle.device
        t = toks.to(dev)
        LAUNCHES.clear()
        logits, state = engine.build_prefill(bundle, prompt + 4)(
            params, {"tokens": t[:, :prompt]})
        got = [logits[:, -1]]
        decode = engine.build_decode(bundle)
        for i in range(prompt, prompt + 3):
            logits, state = decode(params, state, t[:, i: i + 1])
            got.append(logits[:, -1])
        if patches is not None:
            with torch.no_grad():
                carry, ctx = bundle.embed(params, {
                    "tokens": t, "patch_embeds": patches.to(dev)})
                carry = base.run_segments(bundle, params, carry, ctx)
                got.append(bundle.head_logits(params, carry)[:, -1])
        out[name] = ([g.float().cpu() for g in got], dict(LAUNCHES))
    (l_c, n_c), (l_g, n_g) = out["cpu"], out["gpu"]
    rel = max(((g - c).abs().max() / c.abs().max()).item()
              for g, c in zip(l_g, l_c))
    same_greedy = all(torch.equal(g.argmax(-1), c.argmax(-1))
                      for g, c in zip(l_g, l_c))
    kernels = {"int8_matmul"} | ({"int8_matmul_t"} if cfg.tie_embeddings
                                 else set())
    plain = {"deq_matmul"} | ({"deq_matmul_t"} if cfg.tie_embeddings
                              else set())
    if cfg.moe is not None:
        kernels.add("int8_matmul_batched")
        plain.add("deq_matmul_batched")
    prefix = "" if patches is None else " and the forward over a patch prefix"
    log(f"  {arch} f32, {cfg.num_layers} layers, card against CPU: rel err "
        f"{rel:.2e} "
        f"(tolerance {tol:.2e}) over the prefill of {prompt} tokens, 3 "
        f"decode steps{prefix}"
        f", greedy tokens {'equal' if same_greedy else 'DIFFER'}; launches "
        f"card {n_g} CPU {n_c}")
    problems = []
    if set(n_g) != kernels:
        problems.append(f"card launches {n_g}, want {kernels}")
    if set(n_c) != plain:
        problems.append(f"CPU launches {n_c}, want {plain}")
    if rel > tol:
        problems.append(f"rel err {rel:.2e}")
    if not same_greedy and (cfg.moe is not None
                            or cfg.family in ("xlstm", "hybrid")):
        problems.append("greedy tokens differ")
    del p_gpu, p_cpu, gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"f32 parity {arch}: " + "; ".join(problems))
    return {"rel_err": rel, "same_greedy": same_greedy, "launches_card": n_g,
            "launches_cpu": n_c}


def tied_head_rows(seed: int) -> list:
    """Phase 11c: gemma-7b's tied head as a kernel problem, ``h (M, 3072)
    bf16 @ deq(E (256000, 3072))^T`` through ``int8_matmul_t`` at M = 1, 8,
    16 (decode) and slots x prompt, against its plain version (2e-2 of
    max|plain|, the one-pass bf16 bar) and timed beside it, cuBLAS bf16 on
    E dequantized, and the bound."""
    from repro_torch.analysis.roofline import kernel_bound
    from repro_torch.kernels import profile as kprof
    from repro_torch.core import quant
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.kernels import ref
    from repro_torch.models import model_zoo
    cfg = model_zoo.get_config("gemma-7b")
    V, D = cfg.vocab_size, cfg.d_model
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    w = torch.randn((V, D), generator=gen, device=dev) * 0.02
    qt = quant.quantize_blockwise(w, bits=8, symmetric=True)
    del w
    w_lib = quant.dequantize(qt, torch.bfloat16)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    chunk = 256          # the plain version's (M, 12, 256000) f32 partials

    def plain(x):
        return torch.cat([ref.int8_matmul_t_ref(x[i: i + chunk], qt.q,
                                                qt.scale, 256)
                          for i in range(0, x.shape[0], chunk)])

    rows = []
    for M in TIED_MS:
        x = torch.randn((M, D), generator=gen, device=dev).to(torch.bfloat16)
        got = ti8.int8_matmul_t(x, qt.q, qt.scale)
        want = plain(x)
        abs_err = (got - want).abs().max().item()
        rel = abs_err / want.abs().max().item()
        del got, want
        ms = time_ms(lambda: ti8.int8_matmul_t(x, qt.q, qt.scale), flush,
                     reps=10)
        plain_ms = time_ms(lambda: plain(x), flush, reps=3)
        lib_ms = time_ms(lambda: torch.matmul(x, w_lib.T), flush, reps=10)
        b_ms, b_by = kernel_bound(*kprof.int8_matmul_t_cost(M, V, D, 2))
        row = {"M": M, "K": V, "N": D, "g": "bfloat16", "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
               "bound_by": b_by, "max_abs_err": abs_err, "rel_err": rel,
               "tflops": 2 * M * V * D / ms / 1e9,
               "padded_rows": -(-M // ti8.TILE_M_T) * ti8.TILE_M_T,
               "design": mma_design(torch.bfloat16)
               + f", {ti8.TILE_M_T}-row output tiles"}
        rows.append(row)
        log(f"  tied head M={M:5d} K={V} N={D} bf16 g: ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (cuBLAS bf16)"
            f" bound_ms={b_ms:.4f} ({b_by}) tflops={row['tflops']:.1f} "
            f"rows padded to {row['padded_rows']} rel_err={rel:.2e} "
            f"{'ok' if rel <= TOL else 'FAIL'}")
        del x
    del qt, w_lib, flush
    torch.cuda.empty_cache()
    bad = [r for r in rows if r["rel_err"] > TOL]
    if bad:
        raise AssertionError(f"int8_matmul_t disagrees with its plain "
                             f"version at the tied head: {bad}")
    return rows


def phase_dense_variants(seed: int) -> dict:
    """Phase 11: the dense variants at full width (11a, 11b's bf16 half),
    their f32 card-against-CPU parity at 2 layers (11b) and the tied head
    as a kernel problem (11c)."""
    cut = ", ".join(depth_cut(a) for a in DENSE_ARCHS)
    log(f"== phase 11: the dense variants at full width ({cut} in 11a) "
        f"through the paged scheduler (4 slots, 8 requests, prompts "
        f"64-512, 16 new)")
    card = nvidia_smi_line()
    log("card:", card)
    t0 = time.monotonic()
    serve = {a: serve_dense(a, seed) for a in DENSE_ARCHS}
    for a, r in serve.items():
        log(f"  11a {a}: {r['tokens_per_s']:.1f} tok/s, mean TTFT "
            f"{r['mean_ttft_s']:.3f} s, median decode dispatch "
            f"{r['median_decode_step_ms']} ms, INT8 weights "
            f"{r['int8_gib']:.2f} GiB, peak {r['peak_gib']:.2f} GiB, launches"
            f" a decode dispatch {r['launches_per_decode_dispatch']}, decode "
            f"idle share {r['device_idle_share']} [{card}]")
    parity = {a: f32_parity_dense(a, seed) for a in DENSE_ARCHS}
    tied = tied_head_rows(seed)
    wall = time.monotonic() - t0
    log(f"  phase 11 in {wall:.1f} s (cut: {cut} in 11a)")
    return {"serving": serve, "f32_parity": parity, "tied_head": tied,
            "wall_s": wall, "card": card,
            "cuts": {"serving": {a: SERVE_DEPTH[a] for a in DENSE_ARCHS}}}


# ---------------------------------------------------------------------------
# phase 12: the mixture of experts
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-30b-a3b"     # served as phase 11a serves: DENSE_*
MOE_CS = (4, 32, 160, 512)          # decode (4 slots), short prefill,
                                    # training (8 x 256), a 512-token prompt
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS, MOE_RANK = 2, 3, 128


def moe_launches(cfg) -> dict:
    """One forward's kernel launches at full width: ``int8_matmul`` for
    wq, wk, wv, wo and the router a layer and the untied head,
    ``int8_matmul_batched`` for the three expert stacks a layer."""
    return {"int8_matmul": 5 * cfg.num_layers + 1,
            "int8_matmul_batched": 3 * cfg.num_layers}


def batched_tol(E, M, K, N, dtype) -> float:
    """Phase 2's bars at the batched call's plan: two passes (the small-M
    path in both dtypes, f32 x) 1e-4 of max|plain|, one bf16 pass 2e-2."""
    from repro_torch.kernels import int8_matmul as ti8
    two = ti8.plan(M, K, N, E=E).path == 0 or dtype == torch.float32
    return F32_X_TOL if two else TOL


EXPERT_CHUNK = 32    # experts a plain call or a random stack takes at once


def random_stack(E, K, N, gen):
    """A random INT8 expert stack (codes, scales), quantized
    ``EXPERT_CHUNK`` experts at a time (deepseek-v3's (256, 7168, 2048)
    is 15 GB of float32 whole)."""
    from repro_torch.core import quant
    q = torch.empty((E, K, N), dtype=torch.int8, device="cuda")
    s = torch.empty((E, K, N // 256), dtype=torch.float32, device="cuda")
    for e in range(0, E, EXPERT_CHUNK):
        n = min(EXPERT_CHUNK, E - e)
        qt = quant.quantize_blockwise(
            torch.randn((n, K, N), generator=gen, device="cuda") * 0.02,
            bits=8, symmetric=True)
        q[e: e + n].copy_(qt.q)
        s[e: e + n].copy_(qt.scale)
        del qt
    return q, s


def plain_batched(x, q, s, transposed=False):
    """The batched kernels' plain versions, ``EXPERT_CHUNK`` experts a call
    (at E 256 and 512 rows one call's float32 partials are 30 GB)."""
    from repro_torch.kernels import ref
    fn = ref.int8_matmul_t_batched_ref if transposed \
        else ref.int8_matmul_batched_ref
    return torch.cat([fn(x[e: e + EXPERT_CHUNK], q[e: e + EXPERT_CHUNK],
                         s[e: e + EXPERT_CHUNK], 256)
                      for e in range(0, q.shape[0], EXPERT_CHUNK)])


def check_batched(shapes, seed: int) -> dict:
    """Hold ``int8_matmul_batched`` against its plain version at every (E,
    M, K, N, dtype) of a run, on fresh seeded inputs (phase 2's bars)."""
    from repro_torch.kernels import int8_matmul as ti8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 21)
    max_abs, max_rel, failed = 0.0, 0.0, []
    for E, K, N in sorted({s[:1] + s[2:4] for s in shapes}):
        q, sc = random_stack(E, K, N, gen)
        for _, M, _, _, dt in sorted(s for s in shapes
                                     if (s[0],) + s[2:4] == (E, K, N)):
            x = torch.randn((E, M, K), generator=gen, device=dev).to(dt)
            got = ti8.int8_matmul_batched(x, q, sc)
            want = plain_batched(x, q, sc)
            abs_err = (got - want).abs().max().item()
            rel = abs_err / max(want.abs().max().item(), 1e-30)
            max_abs, max_rel = max(max_abs, abs_err), max(max_rel, rel)
            if rel > batched_tol(E, M, K, N, dt):
                failed.append((E, M, K, N, str(dt), rel))
            del x, got, want
        del q, sc
    torch.cuda.empty_cache()
    log(f"  {len(shapes)} distinct int8_matmul_batched problems of the run "
        f"(M in {sorted({s[1] for s in shapes})}) against the plain "
        f"version: max rel err {max_rel:.2e}")
    if failed:
        raise AssertionError(f"int8_matmul_batched disagrees with its plain "
                             f"version: {failed}")
    return {"checked_problems": len(shapes), "check_max_abs_err": max_abs,
            "check_max_rel_err": max_rel}


class BatchedRecorder:
    """Records, while installed, the distinct problems (E, M, K, N, dtype)
    the two batched wrappers are launched with: ``i`` for
    ``int8_matmul_batched``, and ``t`` for ``int8_matmul_t_batched`` with
    each problem's first inputs, copied to the host; ``counts``, the calls
    of each ``(wrapper, K, N)`` from step ``count_from`` on (``dp_run``
    sets ``step``)."""

    def __init__(self):
        self.i, self.t = set(), {}
        self.step = self.count_from = -1
        self.counts = Counter()

    def _count(self, name, q):
        if self.step >= self.count_from:
            self.counts[(name, q.shape[1], q.shape[2])] += 1

    def __enter__(self):
        from repro_torch.kernels import int8_matmul as ti8
        self._saved = (ti8.int8_matmul_batched, ti8.int8_matmul_t_batched)
        k_i, k_t = self._saved

        def rec_i(x, q, scale, block=256):
            self.i.add((q.shape[0], x.shape[1], q.shape[1], q.shape[2],
                        x.dtype))
            self._count("int8_matmul_batched", q)
            return k_i(x, q, scale, block)

        def rec_t(g, q, scale, block=256):
            key = (q.shape[0], g.shape[1], q.shape[1], q.shape[2], g.dtype)
            if key not in self.t:
                self.t[key] = [t.to("cpu", copy=True) for t in (g, q, scale)]
            self._count("int8_matmul_t_batched", q)
            return k_t(g, q, scale, block)

        ti8.int8_matmul_batched, ti8.int8_matmul_t_batched = rec_i, rec_t
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import int8_matmul as ti8
        ti8.int8_matmul_batched, ti8.int8_matmul_t_batched = self._saved
        return False


def padded_share(routed: list, E: int, decode_c: int) -> dict:
    """From each dispatch's ``(capacity, tokens routed to each expert)``:
    the experts with an empty buffer in a decode dispatch (mean over its
    layers), and the mean fill of the expert buffers (kept rows over C)
    at prefill."""
    dec = [c for C, c in routed if C == decode_c]
    pre = [(C, c) for C, c in routed if C != decode_c]
    out = {}
    if dec:
        counts = torch.stack(dec).float()
        empty = (counts == 0).sum(1).float()
        out["decode_empty_experts_mean"] = empty.mean().item()
        out["decode_nonempty_experts_max"] = int((counts > 0).sum(1).max())
        out["decode_empty_share"] = out["decode_empty_experts_mean"] / E
    if pre:
        fills = [(c.clamp(max=C).float().sum() / (E * C)).item()
                 for C, c in pre]
        out["prefill_mean_fill"] = float(np.mean(fills))
        out["prefill_dispatches"] = len(pre)
    return out


def serve_moe(seed: int, cfg=None, want_by=None, tag: str = "12a") -> dict:
    """Phase 12a and 12b's bf16 half: qwen3-moe-30b-a3b at full width and
    ``SERVE_DEPTH``'s depth through ``make_scheduler(backend="auto")``
    (the slot scheduler), every prefill one unpadded request, every
    prefill and decode dispatch held to ``moe_launches``; then the
    decode-against-forward check and every distinct 2-D and batched
    problem against its plain version.
    Phase 13a passes deepseek-v3's ``cfg`` and ``want_by``, the launches
    of a prefill (``_prefill``) and of a decode dispatch (``_step``)."""
    from repro_torch.config import ShapeCell
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.models import model_zoo, moe
    from repro_torch.serve.params import quantize_leaf
    from repro_torch.serve.scheduler import Request, Scheduler, \
        make_scheduler
    cfg = cfg or served_config(MOE_ARCH)
    if want_by is None:
        want_by = {"_prefill": moe_launches(cfg), "_step": moe_launches(cfg)}
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = bundle.init_params(gen, leaf_fn=lambda _, t: quantize_leaf(t),
                                by_layer=True)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = tree_stats(params)
    want_params = model_zoo.count_params(cfg)
    mc = cfg.moe
    attn = (f"MLA (q_lora {cfg.mla.q_lora_rank}, kv_lora "
            f"{cfg.mla.kv_lora_rank}, nope/rope/v {cfg.mla.qk_nope_head_dim}"
            f"/{cfg.mla.qk_rope_head_dim}/{cfg.mla.v_head_dim}), "
            f"{mc.first_dense_layers} dense layers at d_ff {mc.dense_ff}, "
            f"{mc.num_shared_experts} shared expert, MTP {cfg.mtp_depth}"
            if cfg.attention == "mla" else "qk-norm")
    log(f"  {cfg.name}: {cfg.num_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} x {model_zoo.qk_width(cfg)}, "
        f"{attn}, {mc.num_experts} experts top-{mc.top_k}, expert_ff "
        f"{mc.expert_ff}, vocab {cfg.vocab_size}: {st['params'] / 1e9:.2f} B "
        f"parameters ({want_params / 1e9:.2f} B counted on the meta device), "
        f"INT8 codes and scales {st['int8_bytes'] / 2**30:.2f} GiB, float "
        f"{st['float_bytes'] / 2**20:.2f} MiB; drawn and quantized in "
        f"{init_s:.2f} s, peak {init_peak:.2f} GiB")
    problems = []
    if st["params"] != want_params:
        problems.append(f"{st['params']} parameters drawn, "
                        f"{want_params} counted")
    reqs = dense_requests(seed, cfg.vocab_size)
    sched = make_scheduler(bundle, params, backend="auto",
                           num_slots=DENSE_SLOTS, max_len=DENSE_WINDOW,
                           dtype=torch.bfloat16, device="cuda")
    if type(sched) is not Scheduler:
        raise AssertionError(f"backend auto gave {type(sched).__name__}")
    sched.run([Request(rid=-1, tokens=reqs[0].tokens[:64],
                       max_new_tokens=2)])           # warm-up
    sched.reset()
    names = tuple(want_by["_step"])
    ms = {"_prefill": [], "_step": []}
    got_by = {n: [] for n in ms}
    prefill_rows = []

    def timed(name, inner):
        def run(*a):
            before = {n: LAUNCHES[n] for n in names}
            if name == "_prefill":
                prefill_rows.append(tuple(a[1]["tokens"].shape))
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = inner(*a)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t) * 1e3)
            got_by[name].append({n: LAUNCHES[n] - before[n] for n in names})
            return out
        return run

    inner = {n: getattr(sched, n) for n in ms}
    for n in ms:
        setattr(sched, n, timed(n, inner[n]))
    shapes: set = set()
    kernel = ti8.int8_matmul

    def recording(x, q, scale, block=256, p=None):
        shapes.add((x.shape[0], q.shape[0], q.shape[1], x.dtype))
        return kernel(x, q, scale, block, p)

    # each dispatch's routing: per-expert token counts (device tensors, no
    # host sync) at the capacity the serving paths use, C = T (decode passes
    # B·S; a prompt of at most 512 tokens is drop-free)
    routed, route = [], moe._route

    def rec_route(router_w, x, mc_):
        w, e, aux = route(router_w, x, mc_)
        routed.append((x.shape[0], torch.bincount(e.reshape(-1),
                                                  minlength=mc_.num_experts)))
        return w, e, aux

    ti8.int8_matmul = recording
    moe._route = rec_route
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.monotonic()
    try:
        with BatchedRecorder() as brec:
            comps = sched.run(reqs)
            torch.cuda.synchronize()
    finally:
        ti8.int8_matmul = kernel
        moe._route = route
        for n in ms:
            setattr(sched, n, inner[n])
    wall = time.monotonic() - t0
    counts, stats = dict(LAUNCHES), dict(sched.stats)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, rows in got_by.items():
        bad = [g for g in rows if g != want_by[name]]
        if bad:
            problems.append(f"{name}: {len(bad)} dispatches launched "
                            f"{bad[0]}, want {want_by[name]}")
    by_rid = {c.rid: c for c in comps}
    lens = [len(r.tokens) for r in reqs]
    if sorted(prefill_rows) != sorted((1, n) for n in lens):
        problems.append(f"prefills {prefill_rows}, want one row at each "
                        f"prompt's length {lens}")
    for r in reqs:
        c = by_rid.get(r.rid)
        if c is None or len(c.tokens) != r.max_new_tokens:
            problems.append(f"request {r.rid} incomplete")
    if any(n.endswith("_ref") or n.startswith("deq_") for n in counts):
        problems.append(f"plain versions ran: {counts}")
    share = padded_share(routed, mc.num_experts, DENSE_SLOTS)
    del routed
    n_tok = sum(len(c.tokens) for c in comps)
    per_decode, per_prefill = ({n: sum(g[n] for g in got_by[k])
                                / len(got_by[k]) for n in names}
                               for k in ("_step", "_prefill"))
    out = {"layers": cfg.num_layers, "params": st["params"],
           "int8_gib": st["int8_bytes"] / 2 ** 30, "init_s": init_s,
           "init_peak_gib": init_peak, "tokens_per_s": n_tok / wall,
           "wall_s": wall, "tokens": n_tok,
           "mean_ttft_s": float(np.mean([c.ttft for c in comps])),
           "median_decode_step_ms": statistics.median(ms["_step"]),
           "median_prefill_ms": statistics.median(ms["_prefill"]),
           "dispatches": {n: len(v) for n, v in ms.items()},
           "launches": counts, "launches_per_decode_dispatch": per_decode,
           "launches_per_prefill": per_prefill,
           "launches_per_dispatch_want": want_by["_step"],
           "launches_per_prefill_want": want_by["_prefill"],
           "peak_gib": peak,
           "stats": stats, "padded": share}
    log(f"  {n_tok} tokens in {wall:.2f} s -> {out['tokens_per_s']:.1f} "
        f"tok/s; mean TTFT {out['mean_ttft_s']:.3f} s; median decode "
        f"dispatch {out['median_decode_step_ms']:.2f} ms, prefill "
        f"{out['median_prefill_ms']:.2f} ms; dispatches {out['dispatches']};"
        f" peak {peak:.2f} GiB; launches {counts}; measured a prefill "
        f"{per_prefill} (want {want_by['_prefill']}), a decode dispatch "
        f"{per_decode} (want {want_by['_step']}); padded {share}")
    out.update(profile_decode(sched_stepper(sched, reqs[:DENSE_SLOTS])))
    out["roofline"] = step_roofline(
        tag, cfg, ShapeCell("serve", max(lens), DENSE_SLOTS, "decode"),
        out["median_decode_step_ms"], tokens_per_s=out["tokens_per_s"],
        device_ms=out["profile_step_device_ms"])
    del sched
    errs = decode_vs_forward(bundle, params, seed)
    log(f"  {cfg.name} bf16 decode against the full forward (prefill, then "
        f"4 teacher-forced steps), rel err {['%.2e' % e for e in errs]} "
        f"(tolerance {BF16_PATH_TOL})")
    if max(errs) > BF16_PATH_TOL:
        problems.append(f"decode against forward {errs}")
    out["decode_vs_forward_rel"] = errs
    del params, bundle
    gc.collect()
    torch.cuda.empty_cache()
    out.update(check_shapes(shapes, seed))
    out["batched"] = check_batched(brec.i, seed)
    if problems:
        raise AssertionError(f"phase {tag}: " + "; ".join(problems))
    return out


def moe_expert_rows(seed: int, arch: str = MOE_ARCH, cs=MOE_CS,
                    dtypes=(torch.bfloat16, torch.float32)) -> dict:
    """Phase 12c (and 13c): both batched kernels at ``arch``'s expert
    problems (qwen3-moe: E 128, (K, N) = (2048, 768) and (768, 2048), C in
    ``MOE_CS``, bf16 and f32), each against its plain version and timed
    (cold L2, median of 20) beside E launches of the 2-D kernel (one an
    expert, each at its own plan; never on the path), one ``torch.bmm`` on
    the bf16 stack dequantized beforehand, and the bound."""
    from repro_torch.analysis.roofline import kernel_bound
    from repro_torch.kernels import profile as kprof
    from repro_torch.core import quant
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.models import model_zoo
    cfg = model_zoo.get_config(arch)
    mc = cfg.moe
    E = mc.num_experts
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 22)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {"int8_matmul_batched": [], "int8_matmul_t_batched": []}
    failed = []
    for K, N in ((cfg.d_model, mc.expert_ff), (mc.expert_ff, cfg.d_model)):
        q, s = random_stack(E, K, N, gen)
        w_lib = torch.empty((E, K, N), dtype=torch.bfloat16, device=dev)
        for e in range(0, E, EXPERT_CHUNK):
            w_lib[e: e + EXPERT_CHUNK] = quant.dequantize(quant.QTensor(
                q[e: e + EXPERT_CHUNK], s[e: e + EXPERT_CHUNK], None, 8, 256,
                N, "float32"), torch.bfloat16)
        for C in cs:
            for dt in dtypes:
                for name in rows:
                    t = name == "int8_matmul_t_batched"
                    x = torch.randn((E, C, N if t else K), generator=gen,
                                    device=dev).to(dt)
                    xl = x.to(torch.bfloat16)
                    if t:
                        run = lambda: ti8.int8_matmul_t_batched(x, q, s)
                        plain = lambda: plain_batched(x, q, s, True)
                        per = lambda: [ti8.int8_matmul_t(x[e], q[e], s[e])
                                       for e in range(E)]
                        lib = lambda: torch.bmm(xl, w_lib.transpose(1, 2))
                        tol = F32_X_TOL
                    else:
                        run = lambda: ti8.int8_matmul_batched(x, q, s)
                        plain = lambda: plain_batched(x, q, s)
                        per = lambda: [ti8.int8_matmul(x[e], q[e], s[e])
                                       for e in range(E)]
                        lib = lambda: torch.bmm(xl, w_lib)
                        tol = batched_tol(E, C, K, N, dt)
                    got, want = run(), plain()
                    abs_err = (got - want).abs().max().item()
                    rel = abs_err / max(want.abs().max().item(), 1e-30)
                    del got, want
                    row = {"E": E, "M": C, "K": K, "N": N,
                           "x": str(dt).replace("torch.", ""),
                           "ms": time_ms(run, flush),
                           "per_expert_ms": time_ms(per, flush, reps=10),
                           "plain_ms": time_ms(plain, flush, reps=5),
                           "library_ms": time_ms(lib, flush),
                           "max_abs_err": abs_err, "rel_err": rel,
                           "tol": tol}
                    row["bound_ms"], row["bound_by"] = kernel_bound(
                        *kprof.batched_cost(E, C, K, N, dt.itemsize, t))
                    row["tflops"] = 2 * E * C * K * N / row["ms"] / 1e9
                    row["x_bound"] = row["ms"] / row["bound_ms"]
                    row["x_per_expert"] = row["ms"] / row["per_expert_ms"]
                    if not t:
                        row["design"] = i8_design(C, K, N, dt) \
                            if ti8.plan(C, K, N, E=E).path else (
                                "mma.sync bf16 x2 (hi/lo) small-M, "
                                f"{ti8.plan(C, K, N, E=E).splits} split(s)")
                    else:
                        row["design"] = mma_design(dt)
                    rows[name].append(row)
                    ok = rel <= tol
                    if not ok:
                        failed.append((name, row))
                    log(f"  {name} E={E} C={C} K={K} N={N} x={row['x']} "
                        f"ms={row['ms']:.4f} per_expert_ms="
                        f"{row['per_expert_ms']:.4f} plain_ms="
                        f"{row['plain_ms']:.4f} library_ms="
                        f"{row['library_ms']:.4f} (torch.bmm bf16) bound_ms="
                        f"{row['bound_ms']:.4f} ({row['bound_by']}) "
                        f"tflops={row['tflops']:.1f} [{row['design']}] "
                        f"rel_err={rel:.2e} {'ok' if ok else 'FAIL'}")
                    del x, xl
        del q, s, w_lib
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"batched kernels disagree with their plain "
                             f"versions: {failed}")
    return rows


def check_batched_t(probs: dict, seed: int) -> list:
    """``int8_matmul_t_batched`` at the training run's distinct problems,
    on the run's own bf16 g and on f32 g beside it (``f32_beside``), as
    phase 5 holds ``int8_matmul_t``: 1e-4 of max|plain|, and for f32 g the
    error one bf16 pass would leave above that bar."""
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    rows, failed = [], []
    for key, (g_run, q, s) in sorted(probs.items(), key=lambda kv: kv[0][:4]):
        g_run, q, s = g_run.cuda(), q.cuda(), s.cuda()
        gs = (g_run,) if g_run.dtype == torch.float32 else (
            g_run, f32_beside(g_run, gen))
        for g in gs:
            got = ti8.int8_matmul_t_batched(g, q, s)
            want = ref.int8_matmul_t_batched_ref(g, q, s, 256)
            peak = max(want.abs().max().item(), 1e-30)
            rel = (got - want).abs().max().item() / peak
            hi = None
            if g.dtype == torch.float32:
                hi = (ref.int8_matmul_t_batched_ref(
                    g.to(torch.bfloat16), q, s, 256) - want).abs().max() \
                    .item() / peak
            ok = rel <= F32_X_TOL and (hi is None or hi > F32_X_TOL)
            row = {"E": key[0], "M": key[1], "K": key[2], "N": key[3],
                   "g": str(g.dtype).replace("torch.", ""),
                   "on_path": g.dtype == key[4], "rel_err": rel,
                   "hi_only_rel": hi, "ok": ok}
            rows.append(row)
            if not ok:
                failed.append(row)
            log(f"  int8_matmul_t_batched (training) E={key[0]} M={key[1]} "
                f"K={key[2]} N={key[3]} g={row['g']} rel_err={rel:.2e}"
                + ("" if hi is None else f" hi_only_rel={hi:.2e}")
                + f" {'ok' if ok else 'FAIL'}")
            del got, want
    if failed:
        raise AssertionError(f"int8_matmul_t_batched disagrees with its "
                             f"plain version at training problems: {failed}")
    return rows


def train_moe(seed: int, cfg=None, want=None, tag: str = "12c") -> dict:
    """Phase 12c's training run: qwen3-moe-30b-a3b at full width and 2
    layers, the ``qgalore`` preset at rank 128 with the randomized
    subspace method, 8 x 256 tokens, 3 steps. Each steady step's launches
    are held to what the code implies (``want``, a steady step's; the
    refresh step launches no update), and the batched transpose's
    problems against its plain version. Phase 13c passes deepseek-v3's
    ``cfg`` and ``want``."""
    from repro_torch.config import (QGaLoreConfig, ShapeCell, TrainConfig,
                                    replace)
    from repro_torch.core.optimizers import preset
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import profile as kprof
    from repro_torch.models import model_zoo
    from repro_torch.train.trainer import Trainer
    cfg = cfg or replace(model_zoo.get_config(MOE_ARCH),
                         num_layers=MOE_TRAIN_LAYERS)
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16)
    qcfg = preset("qgalore", QGaLoreConfig(rank=MOE_RANK,
                                           subspace_method="randomized"))
    tcfg = TrainConfig(seed=seed, global_batch=8, seq_len=256,
                       steps=MOE_TRAIN_STEPS, learning_rate=1e-3,
                       warmup_steps=1, grad_clip=1.0, log_every=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tr = Trainer(bundle, tcfg, qcfg)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    units = sum(s.nbatch for s in tr.specs if s.galore)
    L = cfg.num_layers
    if want is None:
        fwd = moe_launches(cfg)
        # forward + recompute of every block (the head and embedding are
        # not recomputed), dL/dx of every INT8 matmul, one update a unit
        want = {"int8_matmul": 2 * fwd["int8_matmul"] - 1,
                "int8_matmul_batched": 2 * fwd["int8_matmul_batched"],
                "int8_matmul_t": fwd["int8_matmul"],
                "int8_matmul_t_batched": 3 * L}
    want = dict(want, fused_qgalore_update=units)
    names = tuple(want) + PLAIN_NAMES + ("int8_matmul_batched_ref",
                                         "int8_matmul_t_batched_ref",
                                         "deq_matmul_batched",
                                         "deq_matmul_t_batched")
    sub_s = []
    from repro_torch.core import projector
    sub = projector.compute_subspace

    def timed_sub(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = sub(*a, **k)
        torch.cuda.synchronize()
        sub_s.append(time.perf_counter() - t)
        return out

    projector.compute_subspace = timed_sub
    LAUNCHES.clear()
    try:
        with BatchedRecorder() as brec:
            rows = run_counted(tr, tcfg.steps - 1, names)
            # the last steady step counted by kernels/profile.py too (the
            # bound of each kernel's calls; no device time is taken here)
            kprof.reset()
            with kprof.recording():
                rows += run_counted(tr, tcfg.steps, names)
            recorded = kprof.snapshot()
            kprof.reset()
    finally:
        projector.compute_subspace = sub
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    problems = []
    for r in rows:
        w = dict(want, **({"fused_qgalore_update": 0} if r["step"] == 0
                          else {}))
        got = {n: r["launches"][n] for n in w}
        if got != w:
            problems.append(f"step {r['step']} launches {got} != {w}")
        plain = {n: c for n, c in r["launches"].items() if n not in w and c}
        if plain:
            problems.append(f"step {r['step']} ran plain versions {plain}")
        if not np.isfinite(r["loss"]):
            problems.append(f"step {r['step']} loss {r['loss']}")
    steady = [r["s"] for r in rows[1:]]
    out = {"layers": L, "rank": MOE_RANK, "units": units, "init_s": init_s,
           "losses": [r["loss"] for r in rows],
           "metrics": [{k: r[k] for k in ("mtp_loss", "aux_loss")
                        if k in r} for r in rows],
           "refresh_step_s": rows[0]["s"], "refresh_subspace_s": sum(sub_s),
           "median_steady_step_ms": statistics.median(steady) * 1e3,
           "tokens_per_s": tcfg.global_batch * tcfg.seq_len
           / statistics.median(steady),
           "peak_gib": peak, "launches": dict(LAUNCHES),
           "launches_per_steady_step": rows[-1]["launches"],
           "launches_want": want}
    log(f"  training {L} layers at full width: {units} GaLore units; losses "
        f"{[round(x, 4) for x in out['losses']]} {out['metrics']}; refresh "
        f"step "
        f"{out['refresh_step_s']:.2f} s (subspace {sum(sub_s):.2f} s); "
        f"median steady step {out['median_steady_step_ms']:.1f} ms; peak "
        f"{peak:.2f} GiB; a steady step launched "
        f"{ {n: out['launches_per_steady_step'][n] for n in want} } (want "
        f"{want})")
    out["roofline"] = step_roofline(
        tag, cfg, ShapeCell("train", tcfg.seq_len, tcfg.global_batch,
                            "train"), out["median_steady_step_ms"],
        rank=qcfg.rank)
    out.update(kernel_report(
        f"phase {tag}'s last steady step ({cfg.name}, {L} layers, rank "
        f"{qcfg.rank}, {tcfg.global_batch} x {tcfg.seq_len})", recorded, {},
        rows[-1]["launches"]))
    del tr, bundle
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"{cfg.name} training: " + "; ".join(problems))
    out["int8_matmul_t_batched"] = check_batched_t(brec.t, seed)
    out["batched_forward"] = check_batched(brec.i, seed)
    return out


def phase_moe(seed: int) -> dict:
    """Phase 12: qwen3-moe-30b-a3b served at full width and 12 of its 48
    layers (12a), its answers (12b: bf16 decode against the forward inside
    12a; f32 card against CPU at 2 layers), the batched kernels at the
    expert problems and a 2-layer full-width training run (12c)."""
    log(f"== phase 12: {MOE_ARCH} (128 experts top-8) through the slot "
        f"scheduler ({DENSE_SLOTS} slots, {DENSE_REQS} requests, prompts "
        f"{DENSE_PROMPT[0]}-{DENSE_PROMPT[1]}, {DENSE_NEW} new)")
    card = nvidia_smi_line()
    log("card:", card)
    log(f"  cuts: 12a {depth_cut(MOE_ARCH)}; 12b's f32 parity and 12c's "
        f"training 2 layers; every width as published")
    t0 = time.monotonic()
    serve = serve_moe(seed)
    log(f"  12a {MOE_ARCH}: {serve['tokens_per_s']:.1f} tok/s, mean TTFT "
        f"{serve['mean_ttft_s']:.3f} s, median decode dispatch "
        f"{serve['median_decode_step_ms']:.2f} ms, INT8 weights "
        f"{serve['int8_gib']:.2f} GiB, peak {serve['peak_gib']:.2f} GiB, "
        f"decode idle share {serve['device_idle_share']}, device "
        f"{serve['profile_step_device_ms']} ms a decode step [{card}]")
    parity = f32_parity_dense(MOE_ARCH, seed)
    kernels = moe_expert_rows(seed)
    training = train_moe(seed)
    wall = time.monotonic() - t0
    log(f"  phase 12 in {wall:.1f} s")
    return {"serving": serve, "f32_parity": parity, "kernels": kernels,
            "training": training, "wall_s": wall, "card": card,
            "cuts": {"serving": SERVE_DEPTH[MOE_ARCH]}}


# ---------------------------------------------------------------------------
# phase 13: MLA and multi-token prediction
# ---------------------------------------------------------------------------

MLA_ARCH = "deepseek-v3-671b"
# the cuts: 7 of 61 layers serve (the 3 dense and 4 MoE layers, 47.6 GiB of
# INT8; 61 are ~625 GiB); the CPU parity holds 16 of the 256 experts (the
# CPU's plain expert stack would be 45 GB of float32 a layer); training
# holds 32 (a refresh's full-rank expert gradient would be 45 GB a layer)
MLA_SERVE_LAYERS = 7
MLA_PARITY_EXPERTS, MLA_TRAIN_EXPERTS = 16, 32
MLA_CS = (4, 512)                   # decode (4 slots), a 512-token prompt


def mla_launches(cfg, decode: bool) -> dict:
    """One forward's launches at full width: ``int8_matmul`` for
    ``wq_a``, ``wq_b``, ``wkv_a``, ``wo`` and (but in the absorbed decode,
    which materializes it) ``wkv_b`` a layer, the FFN's three a dense
    layer, the router and the shared expert's three an MoE layer, and the
    head; ``int8_matmul_batched`` for the three expert stacks a layer."""
    mc = cfg.moe
    attn = 4 if decode else 5
    n_moe = cfg.num_layers - mc.first_dense_layers
    return {"int8_matmul": mc.first_dense_layers * (attn + 3)
            + n_moe * (attn + 1 + 3) + 1,
            "int8_matmul_batched": 3 * n_moe}


def mla_train_launches(cfg) -> dict:
    """A training step's launches but the updates: the blocks' forward and
    their recompute, the head's loss once (the head, ``mtp_proj``, the MTP
    block's attention and FFN, the head again), ``dL/dx`` of each."""
    fwd = mla_launches(cfg, decode=False)
    blocks = fwd["int8_matmul"] - 1
    head = 1 + 1 + (5 + 3) + 1
    return {"int8_matmul": 2 * blocks + head,
            "int8_matmul_batched": 2 * fwd["int8_matmul_batched"],
            "int8_matmul_t": blocks + head,
            "int8_matmul_t_batched": fwd["int8_matmul_batched"]}


def phase_mla(seed: int) -> dict:
    """Phase 13: deepseek-v3-671b served at full width and 7 layers (13a),
    its answers (13b: bf16 decode against the forward inside 13a; f32 card
    against CPU at 2 layers and 16 experts), both batched kernels at its
    expert problems and 3 training steps with MTP at 2 layers and 32
    experts (13c)."""
    from repro_torch.config import replace
    from repro_torch.models import model_zoo
    full = model_zoo.get_config(MLA_ARCH)
    mc = full.moe
    cfg = replace(full, num_layers=MLA_SERVE_LAYERS)
    log(f"== phase 13: {MLA_ARCH} (MLA, {mc.num_experts} experts top-"
        f"{mc.top_k}, MTP) through the slot scheduler ({DENSE_SLOTS} slots, "
        f"{DENSE_REQS} requests, prompts {DENSE_PROMPT[0]}-{DENSE_PROMPT[1]}"
        f", {DENSE_NEW} new)")
    card = nvidia_smi_line()
    log("card:", card)
    log(f"  cuts: 13a serves {MLA_SERVE_LAYERS} of {full.num_layers} layers "
        f"({mc.first_dense_layers} dense, "
        f"{MLA_SERVE_LAYERS - mc.first_dense_layers} MoE; all "
        f"{full.num_layers} would not fit 80 GB); 13b 2 layers and "
        f"{MLA_PARITY_EXPERTS} of {mc.num_experts} experts (the CPU's plain "
        f"expert stacks); 13c 2 layers and {MLA_TRAIN_EXPERTS} experts (a "
        f"refresh's full-rank expert gradients); every width as published")
    t0 = time.monotonic()
    want_by = {"_prefill": mla_launches(cfg, decode=False),
               "_step": mla_launches(cfg, decode=True)}
    serve = serve_moe(seed, cfg=cfg, want_by=want_by, tag="13a")
    log(f"  13a {MLA_ARCH} at {MLA_SERVE_LAYERS} layers: "
        f"{serve['tokens_per_s']:.1f} tok/s, mean TTFT "
        f"{serve['mean_ttft_s']:.3f} s, median decode dispatch "
        f"{serve['median_decode_step_ms']:.2f} ms, INT8 weights "
        f"{serve['int8_gib']:.2f} GiB, init peak "
        f"{serve['init_peak_gib']:.2f} GiB, peak {serve['peak_gib']:.2f} GiB,"
        f" decode idle share {serve['device_idle_share']}, device "
        f"{serve['profile_step_device_ms']} ms a decode step, measured "
        f"launches a prefill {serve['launches_per_prefill']}, a decode "
        f"dispatch {serve['launches_per_decode_dispatch']}, padded "
        f"{serve['padded']} [{card}]")

    def cut(layers, experts):
        return replace(full, num_layers=layers, moe=replace(
            mc, num_experts=experts, first_dense_layers=1))

    parity = f32_parity_dense(MLA_ARCH, seed, cfg=cut(2, MLA_PARITY_EXPERTS))
    kernels = moe_expert_rows(seed, arch=MLA_ARCH, cs=MLA_CS,
                              dtypes=(torch.bfloat16,))
    tcfg = cut(2, MLA_TRAIN_EXPERTS)
    training = train_moe(seed, cfg=tcfg, want=mla_train_launches(tcfg),
                         tag="13c")
    if not all(np.isfinite(m["mtp_loss"]) for m in training["metrics"]):
        raise AssertionError(f"13c mtp_loss {training['metrics']}")
    wall = time.monotonic() - t0
    log(f"  phase 13 in {wall:.1f} s")
    return {"serving": serve, "f32_parity": parity, "kernels": kernels,
            "training": training, "wall_s": wall, "card": card,
            "cuts": {"serve_layers": MLA_SERVE_LAYERS,
                     "parity": {"layers": 2,
                                "experts": MLA_PARITY_EXPERTS},
                     "training": {"layers": 2,
                                  "experts": MLA_TRAIN_EXPERTS}}}


# ---------------------------------------------------------------------------
# phase 14: xLSTM
# ---------------------------------------------------------------------------

XLSTM_ARCH = "xlstm-125m"
# 14b: one group (5 mLSTM and 1 sLSTM block) of the two: the CPU's plain
# matmuls at full width; a prompt of two mLSTM chunks of 256
XLSTM_PARITY_LAYERS, XLSTM_PARITY_PROMPT = 6, 300
# 14c: rank 256, the 130M-class row of benchmarks/table2_memory.py;
# 4 x 512 tokens (two chunks); step 0 refreshes, steps 1-3 are steady
XLSTM_RANK, XLSTM_TRAIN_STEPS, XLSTM_TRAIN_BATCH = 256, 4, (4, 512)


def xlstm_launches(cfg) -> dict:
    """A forward's ``int8_matmul`` launches: ``w_up``, ``wq``, ``wk``,
    ``wv`` and ``w_down`` of every mLSTM block (its ``w_gates``, 2H wide,
    stays float), ``w_gates`` and the FFN's three of every sLSTM block,
    and the head."""
    every = cfg.xlstm.slstm_every
    return {"int8_matmul": cfg.num_layers // every * (5 * (every - 1) + 4)
            + 1}


def profile_prefill(bundle, params, tokens, module, loops) -> dict:
    """One prompt's prefill under the profiler (device busy against the
    host clock), then the same prefill with the functions ``loops`` of
    ``module`` (xLSTM's mLSTM chunk loop and sLSTM time loop, the SSD's
    chunk loop) timed apart (a synchronize at each one's entry and exit,
    so the rest is the matmuls and norms between them)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import engine
    prefill = engine.build_prefill(bundle, len(tokens) + 1)
    batch = {"tokens": torch.from_numpy(tokens)[None].cuda()}
    prefill(params, batch)
    torch.cuda.synchronize()
    out = {"prompt": len(tokens)}
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill(params, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms = sum(t for _, t, _ in device_rows(prof)) / 1e3
        out.update(profile_wall_ms=wall_ms, profile_device_ms=busy_ms,
                   device_idle_share=1 - busy_ms / wall_ms)
    except RuntimeError as e:
        log(f"  PROFILER FAILED: {e}")
        out.update(profile_wall_ms=None, profile_device_ms=None,
                   device_idle_share=None, profile_error=str(e))
    spent = {n: [] for n in loops}
    saved = {n: getattr(module, n) for n in spent}

    def timed(name):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = saved[name](*a, **k)
            torch.cuda.synchronize()
            spent[name].append((time.perf_counter() - t) * 1e3)
            return res
        return run

    for n in spent:
        setattr(module, n, timed(n))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        out["split_wall_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)
    for n, ts in spent.items():
        out[n + "_ms"] = sum(ts)
        out[n + "_calls"] = len(ts)
    parts = ", ".join(f"{n} {out[n + '_ms']:.1f} ms ({out[n + '_calls']} "
                      f"calls)" for n in loops)
    log(f"  prefill of {len(tokens)} tokens: wall "
        f"{out['profile_wall_ms']} ms, device busy "
        f"{out['profile_device_ms']} ms, idle share "
        f"{out['device_idle_share']}; timed apart: wall "
        f"{out['split_wall_ms']:.1f} ms, {parts}")
    return out


def rounding_sensitivity(cfg, seed: int, prompt: int, frames: int = 0
                         ) -> dict:
    """How far a model's f32 logits move for a rounding-sized change of
    their input (phases 14b, 15b and 16b): on the CPU (plain versions),
    one prompt's prefill with the embeddings (``carry["h"]``; an
    encoder-decoder's ``frames`` normalised and its decoder's ``dec_h``
    too) as drawn and scaled by ``1 + 2^-20 * sign(noise)``;
    ``amplification`` is the logits' relative change over 2^-20. The
    card's f32 matmuls each agree with their plain versions to
    ``F32_X_TOL`` of max|plain| (two bf16 passes), so the f32 parity bar
    for such a model is ``amplification * F32_X_TOL`` where that exceeds
    the well-conditioned models' ``PARITY_TOL``."""
    from repro_torch.models import model_zoo
    from repro_torch.serve import engine
    from repro_torch.serve.params import quantize_leaf
    bundle = model_zoo.build(cfg, device="cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(seed + 24)
    params = bundle.init_params(gen, leaf_fn=lambda _, t: quantize_leaf(t))
    rng = np.random.default_rng(seed + 24)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(1, prompt))
                            .astype(np.int32))
    eps = 2.0 ** -20
    shapes = {"h": (1, frames or prompt, cfg.d_model)}
    if frames:
        shapes["dec_h"] = (1, prompt, cfg.d_model)
    signs = {k: torch.from_numpy(np.sign(rng.standard_normal(sh))
                                 .astype(np.float32))
             for k, sh in shapes.items()}
    batch = {"tokens": toks}
    if frames:
        batch["frames"] = torch.from_numpy((rng.standard_normal(
            (1, frames, cfg.d_model)) * 0.5).astype(np.float32))

    def logits(moved: bool):
        def scaled(p, b):
            carry, ctx = bundle.embed(p, b)
            if moved:
                carry = {**carry, **{k: carry[k] * (1 + eps * sg)
                                     for k, sg in signs.items()}}
            return carry, ctx
        out, _ = engine.build_prefill(
            dataclasses.replace(bundle, embed=scaled), prompt + 1)(
            params, batch)
        return out[:, -1]

    base_l = logits(False)
    moved = logits(True)
    change = ((moved - base_l).abs().max() / base_l.abs().max()).item()
    amp = change / eps
    log(f"  f32 sensitivity ({cfg.num_layers} layers, {prompt}-token "
        f"prompt{f', {frames} frames' if frames else ''}, CPU): the "
        f"embeddings moved by 2^-20 move the logits by "
        f"{change:.2e} of max|logits|, amplification {amp:.0f}; parity bar "
        f"{amp:.0f} x {F32_X_TOL} = {amp * F32_X_TOL:.2e}")
    return {"logit_change": change, "amplification": amp,
            "parity_tol": amp * F32_X_TOL}


def slot_tokens(bundle, params, reqs, slots: int, state_dtype=None) -> dict:
    """Each request's tokens through a ``slots``-slot ``Scheduler`` at
    bf16; ``state_dtype`` stores every pool leaf in that dtype instead (a
    control: what a pool of one dtype would do to the states)."""
    from repro_torch.serve import scheduler as sch
    init = sch.init_pool

    def recast(*a, **k):
        pool = init(*a, **k)
        return pool._replace(caches={
            key: tuple(c.to(state_dtype) for c in leaves)
            for key, leaves in pool.caches.items()})

    if state_dtype is not None:
        sch.init_pool = recast
    try:
        sched = sch.make_scheduler(bundle, params, backend="slot",
                                   num_slots=slots, max_len=DENSE_WINDOW,
                                   dtype=torch.bfloat16, device="cuda")
        return {c.rid: c.tokens for c in sched.run(reqs)}
    finally:
        sch.init_pool = init


def batch_dependence(bundle, params, reqs, ops: bool = False) -> dict:
    """Whether a decode row depends on how many rows share the dispatch:
    request 0's decode step alone (one slot) and as row 0 of four slots
    (the other rows other requests), from the same prefill state, at bf16
    and at f32 (a bundle and pool of f32 activations on the same INT8
    weights). Reordered sums move the f32 row by rounding only; a fault in
    multi-slot decode (a state written to or read from another slot, a row
    mixed into another) moves it by O(1), so the f32 row must agree within
    ``BATCH_ROW_TOL`` of max|logits|. With ``ops``, two of xLSTM's plain
    PyTorch ops (the RMSNorm's mean, the mLSTM gates' float32 matmul) on
    one row alone and in four."""
    from repro_torch.models import model_zoo
    from repro_torch.models.layers import rmsnorm
    from repro_torch.serve import engine
    from repro_torch.serve.scheduler import init_pool, insert_requests
    res = {}
    for dt, b in ((torch.bfloat16, bundle),
                  (torch.float32, model_zoo.build(bundle.cfg, device="cuda",
                                                  dtype=torch.float32))):
        prefill = engine.build_prefill(b, DENSE_WINDOW)
        decode = engine.build_decode(b)
        rows = [prefill(params, {"tokens": torch.from_numpy(r.tokens)[None]
                                 .cuda()}) for r in reqs[:DENSE_SLOTS]]
        toks = torch.stack([lg[:, -1].argmax(-1) for lg, _ in rows]) \
            .to(torch.int32)
        out = {}
        for n in (1, DENSE_SLOTS):
            pool = init_pool(b, n, DENSE_WINDOW, dt, "cuda")
            for i in range(n):
                insert_requests(pool, [i], rows[i][1])
            logits, _ = decode(params, pool, toks[:n])
            out[n] = logits[0].float()
        d = (out[1] - out[DENSE_SLOTS]).abs().max().item()
        pre = "" if dt == torch.bfloat16 else "f32_"
        res.update({pre + "decode_row_max_abs_diff": d,
                    pre + "decode_row_rel_diff": d / out[1].abs().max().item(),
                    pre + "decode_row_equal": d == 0.0})
        del rows, pool, out
    gc.collect()
    torch.cuda.empty_cache()
    msg = (f"  batch dependence: request 0's decode logits alone and as row "
           f"0 of {DENSE_SLOTS} differ by {res['decode_row_max_abs_diff']:.3e}"
           f" max abs ({res['decode_row_rel_diff']:.2e} of max|logits|) at "
           f"bf16, {res['f32_decode_row_max_abs_diff']:.3e} "
           f"({res['f32_decode_row_rel_diff']:.2e}) at f32 (tolerance "
           f"{BATCH_ROW_TOL})")
    if ops:
        gen = torch.Generator(device="cuda").manual_seed(7)
        x = torch.randn((DENSE_SLOTS, 1, bundle.cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        w = torch.zeros((bundle.cfg.d_model,), device="cuda")
        u = torch.randn((DENSE_SLOTS, 1536), generator=gen, device="cuda")
        wg = torch.randn((1536, 8), generator=gen, device="cuda")
        res.update(rmsnorm_row_equal=torch.equal(rmsnorm(x[:1], w),
                                                 rmsnorm(x, w)[:1]),
                   gates_matmul_row_equal=torch.equal(u[:1] @ wg,
                                                      (u @ wg)[:1]))
        msg += (f"; one row alone and in {DENSE_SLOTS}, bit-equal: RMSNorm "
                f"{res['rmsnorm_row_equal']}, f32 gates matmul "
                f"{res['gates_matmul_row_equal']}")
    log(msg)
    return res


def bf16_noise(bundle, params, seed: int, prompt: int = 32,
               steps: int = 4) -> list:
    """The bf16 forward's logits against the f32 forward's on the same
    INT8 weights and ``decode_vs_forward``'s tokens (relative to
    max|f32|): the rounding that the bf16 decode-against-forward check
    sits beside."""
    from repro_torch.models import base, model_zoo
    rng = np.random.default_rng(seed + 12)
    toks = torch.from_numpy(rng.integers(
        1, bundle.cfg.vocab_size, size=(1, prompt + steps))
        .astype(np.int32)).cuda()
    f32 = model_zoo.build(bundle.cfg, device="cuda", dtype=torch.float32)

    @torch.no_grad()
    def last(b, upto):
        carry, ctx = b.embed(params, {"tokens": toks[:, :upto]})
        carry = base.run_segments(b, params, carry, ctx)
        return b.head_logits(params, carry)[:, -1].float()

    errs = []
    for upto in range(prompt, prompt + steps + 1):
        want = last(f32, upto)
        errs.append(((last(bundle, upto) - want).abs().max()
                     / want.abs().max()).item())
    return errs


def serve_xlstm(seed: int) -> dict:
    """Phase 14a and 14b's bf16 half: xlstm-125m at full width and depth
    through ``serve_recurrent``, the pool's seven state leaves float32,
    the mLSTM chunk loops and sLSTM time loops of a prefill timed apart,
    and the batch dependence of a decode row."""
    from repro_torch.models import model_zoo, xlstm
    cfg = model_zoo.get_config(XLSTM_ARCH)
    xc = cfg.xlstm
    inner = int(xc.proj_factor * cfg.d_model)
    groups = cfg.num_layers // xc.slstm_every
    return serve_recurrent(
        cfg, seed, tag="14a", want=xlstm_launches(cfg),
        describe=(f"{cfg.num_layers} layers ({groups} groups of "
                  f"{xc.slstm_every - 1} mLSTM and 1 sLSTM block), d "
                  f"{cfg.d_model}, {cfg.num_heads} heads, mLSTM inner "
                  f"{inner} (head {inner // cfg.num_heads}), chunk "
                  f"{xc.chunk_size}, vocab {cfg.vocab_size}"),
        pool_dtypes=[torch.float32] * 7,
        loops=(xlstm, ("mlstm_chunked", "slstm_scan")), probe_ops=True)


def serve_recurrent(cfg, seed: int, *, tag: str, want: dict, describe: str,
                    pool_dtypes: list, loops: tuple, by_layer: bool = False,
                    probe_ops: bool = False) -> dict:
    """Phases 14a and 15a (and the bf16 halves of 14b and 15b): a
    recurrent model (a bundle without ``ragged_prefill_ok``) at full width
    and depth through ``make_scheduler(backend="auto")`` (the slot
    scheduler, one unpadded request a prefill), the pool's leaf dtypes
    held to ``pool_dtypes`` at a bf16 pool, every prefill and decode
    dispatch held to ``want``; the slot tokens against per-request
    ``generate``, the decode against the full forward, a decode step's and
    a prefill's profile (``loops``: a module and the functions of it timed
    apart) and every distinct ``int8_matmul`` problem against its plain
    version. ``by_layer`` draws the weights one layer of a group at a
    time; ``probe_ops`` adds xLSTM's plain ops to ``batch_dependence``."""
    from repro_torch.config import ShapeCell
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.models import model_zoo
    from repro_torch.serve import engine
    from repro_torch.serve.params import quantize_leaf
    from repro_torch.serve.scheduler import Request, Scheduler, \
        make_scheduler
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = bundle.init_params(gen, leaf_fn=lambda _, t: quantize_leaf(t),
                                by_layer=by_layer)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = tree_stats(params)
    want_params = model_zoo.count_params(cfg)
    log(f"  {cfg.name}: {describe}: {st['params'] / 1e9:.3f} B parameters "
        f"({want_params / 1e9:.3f} B counted on the meta device), INT8 "
        f"codes and scales {st['int8_bytes'] / 2**30:.3f} GiB, float "
        f"{st['float_bytes'] / 2**20:.3f} MiB; drawn and quantized in "
        f"{init_s:.2f} s, peak {init_peak:.3f} GiB")
    problems = []
    if st["params"] != want_params:
        problems.append(f"{st['params']} parameters drawn, "
                        f"{want_params} counted")
    reqs = dense_requests(seed, cfg.vocab_size)
    sched = make_scheduler(bundle, params, backend="auto",
                           num_slots=DENSE_SLOTS, max_len=DENSE_WINDOW,
                           dtype=torch.bfloat16, device="cuda")
    if type(sched) is not Scheduler:
        raise AssertionError(f"backend auto gave {type(sched).__name__}")
    leaves = sched.pool.caches[bundle.seg_key(0)]
    pool = {"shapes": [list(c.shape) for c in leaves],
            "dtypes": [str(c.dtype) for c in leaves],
            "bytes": sum(c.nbytes for c in leaves)}
    log(f"  slot pool ({DENSE_SLOTS} slots, a bf16 pool): leaves "
        f"{list(zip(pool['shapes'], pool['dtypes']))}, "
        f"{pool['bytes'] / 2**20:.2f} MiB")
    if [c.dtype for c in leaves] != pool_dtypes:
        problems.append(f"pool leaves {pool['dtypes']}, want {pool_dtypes}")
    if pool["bytes"] != pool_bytes_slot(bundle, DENSE_SLOTS, DENSE_WINDOW):
        problems.append("pool_bytes_slot disagrees with the pool")
    sched.run([Request(rid=-1, tokens=reqs[0].tokens[:64],
                       max_new_tokens=2)])           # warm-up
    sched.reset()
    ms = {"_prefill": [], "_step": []}
    got_by = {n: [] for n in ms}
    prefill_rows = []

    def timed(name, inner_fn):
        def run(*a):
            before = LAUNCHES["int8_matmul"]
            if name == "_prefill":
                prefill_rows.append(tuple(a[1]["tokens"].shape))
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = inner_fn(*a)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t) * 1e3)
            got_by[name].append(
                {"int8_matmul": LAUNCHES["int8_matmul"] - before})
            return res
        return run

    saved = {n: getattr(sched, n) for n in ms}
    for n in ms:
        setattr(sched, n, timed(n, saved[n]))
    shapes: set = set()
    kernel = ti8.int8_matmul

    def recording(x, q, scale, block=256, p=None):
        shapes.add((x.shape[0], q.shape[0], q.shape[1], x.dtype))
        return kernel(x, q, scale, block, p)

    ti8.int8_matmul = recording
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.monotonic()
    try:
        comps = sched.run(reqs)
        torch.cuda.synchronize()
    finally:
        ti8.int8_matmul = kernel
        for n in ms:
            setattr(sched, n, saved[n])
    wall = time.monotonic() - t0
    counts, stats = dict(LAUNCHES), dict(sched.stats)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, rows in got_by.items():
        bad = [g for g in rows if g != want]
        if bad:
            problems.append(f"{name}: {len(bad)} dispatches launched "
                            f"{bad[0]}, want {want}")
    lens = [len(r.tokens) for r in reqs]
    if sorted(prefill_rows) != sorted((1, n) for n in lens):
        problems.append(f"prefills {prefill_rows}, want one row at each "
                        f"prompt's length {lens}")
    if any(c and (n.endswith("_ref") or n.startswith("deq_"))
           for n, c in counts.items()):
        problems.append(f"plain versions ran: {counts}")
    got_toks = {c.rid: c.tokens for c in comps}
    n_tok = sum(len(t) for t in got_toks.values())
    per_decode, per_prefill = ({"int8_matmul": sum(
        g["int8_matmul"] for g in got_by[k]) / len(got_by[k])}
        for k in ("_step", "_prefill"))
    out = {"layers": cfg.num_layers, "params": st["params"],
           "int8_gib": st["int8_bytes"] / 2 ** 30, "init_s": init_s,
           "init_peak_gib": init_peak,
           "tokens_per_s": n_tok / wall, "wall_s": wall, "tokens": n_tok,
           "mean_ttft_s": float(np.mean([c.ttft for c in comps])),
           "median_decode_step_ms": statistics.median(ms["_step"]),
           "median_prefill_ms": statistics.median(ms["_prefill"]),
           "prefill_ms_total": sum(ms["_prefill"]),
           "dispatches": {n: len(v) for n, v in ms.items()},
           "launches": counts, "launches_per_decode_dispatch": per_decode,
           "launches_per_prefill": per_prefill,
           "launches_per_dispatch_want": want, "peak_gib": peak,
           "stats": stats, "pool": pool}
    log(f"  {n_tok} tokens in {wall:.2f} s -> {out['tokens_per_s']:.1f} "
        f"tok/s; mean TTFT {out['mean_ttft_s']:.3f} s; median decode "
        f"dispatch {out['median_decode_step_ms']:.2f} ms, prefill "
        f"{out['median_prefill_ms']:.2f} ms; dispatches {out['dispatches']};"
        f" peak {peak:.3f} GiB; launches {counts}; measured a prefill "
        f"{per_prefill}, a decode dispatch {per_decode} (want {want})")
    # the slot tokens against per-request ``generate`` (which keeps the
    # prefill's own float32 state: a pool that rounds it parts from it)
    want_toks = {}
    for r in reqs:
        toks, _ = engine.generate(
            bundle, params, {"tokens": torch.from_numpy(r.tokens)[None]},
            steps=r.max_new_tokens - 1, max_len=DENSE_WINDOW,
            device="cuda")
        want_toks[r.rid] = toks[0].tolist()
    # the 4-slot run decodes 4 rows a dispatch where ``generate`` decodes
    # one: the plain ops' reductions may sum in another order (reported);
    # one slot runs generate's shapes, so its tokens must be equal, and a
    # pool that rounds the states to bf16 must part from them (control)
    same4, first4 = first_divergence(got_toks, want_toks)
    same1, first1 = first_divergence(
        slot_tokens(bundle, params, reqs, 1), want_toks)
    same_c, first_c = first_divergence(
        slot_tokens(bundle, params, reqs, 1, torch.bfloat16), want_toks)
    out.update(slot_equals_generate=same1, first_divergence=first1,
               slot4_equals_generate=same4, slot4_first_divergence=first4,
               bf16_pool_equals_generate=same_c,
               bf16_pool_first_divergence=first_c)
    log(f"  slot tokens against per-request generate (bf16): 1 slot "
        f"{same1:.3f} of requests equal (first divergence {first1}); "
        f"{DENSE_SLOTS} slots {same4:.3f} ({first4}); control, 1 slot with "
        f"the states stored in bf16: {same_c:.3f} ({first_c})")
    if same1 != 1.0:
        problems.append(f"slot tokens differ from generate at {first1}")
    bd = out["batch_dependence"] = batch_dependence(bundle, params, reqs,
                                                    ops=probe_ops)
    if bd["f32_decode_row_rel_diff"] > BATCH_ROW_TOL:
        problems.append(f"f32 decode row depends on the batch: {bd}")
    out.update(profile_decode(sched_stepper(sched, reqs[:DENSE_SLOTS])))
    out["roofline"] = step_roofline(
        tag, cfg, ShapeCell("serve", max(lens), DENSE_SLOTS, "decode"),
        out["median_decode_step_ms"], tokens_per_s=out["tokens_per_s"],
        device_ms=out["profile_step_device_ms"])
    del sched
    longest = max(reqs, key=lambda r: len(r.tokens))
    out["prefill_profile"] = profile_prefill(bundle, params, longest.tokens,
                                             *loops)
    errs = decode_vs_forward(bundle, params, seed)
    noise = bf16_noise(bundle, params, seed)
    log(f"  {cfg.name} bf16 decode against the full forward (prefill, then "
        f"4 teacher-forced steps), rel err {['%.2e' % e for e in errs]} "
        f"(tolerance {BF16_PATH_TOL}); the bf16 forward against the f32 "
        f"forward at the same lengths {['%.2e' % e for e in noise]}")
    if max(errs) > BF16_PATH_TOL:
        problems.append(f"decode against forward {errs}")
    out["decode_vs_forward_rel"] = errs
    out["bf16_forward_vs_f32_rel"] = noise
    del params, bundle
    gc.collect()
    torch.cuda.empty_cache()
    out.update(check_shapes(shapes, seed))
    if problems:
        raise AssertionError(f"phase {tag}: " + "; ".join(problems))
    return out


def slstm_gate_rows(seed: int) -> list:
    """Phase 14b: the sLSTM gate projection ``u (M, 768) @ deq(W (768,
    3072))`` with f32 u (the f32 runs; at bf16 the block hands the kernel
    bf16 u, as the reference's ``dense`` does) on ``int8_matmul``'s
    small-M path at decode M 1 and 4: against its plain version (1e-4 of
    max|plain|, and ``hi_only_rel`` above it), timed beside the plain
    version, cuBLAS f32 on the weight dequantized and the bound."""
    from repro_torch.analysis.roofline import kernel_bound
    from repro_torch.kernels import profile as kprof
    from repro_torch.core import quant
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.kernels import ref
    from repro_torch.models import model_zoo
    cfg = model_zoo.get_config(XLSTM_ARCH)
    K, N = cfg.d_model, 4 * cfg.d_model
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 24)
    qt = quant.quantize_blockwise(
        torch.randn((K, N), generator=gen, device=dev) * 0.02, bits=8,
        symmetric=True)
    w_lib = quant.dequantize(qt, torch.float32)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []
    for M in (1, DENSE_SLOTS):
        x = torch.randn((M, K), generator=gen, device=dev)
        abs_err, rel = check_against_plain(x, qt)
        hi_only = i8_hi_only(x, qt)
        ms = time_ms(lambda: ti8.int8_matmul(x, qt.q, qt.scale), flush)
        plain_ms = time_ms(lambda: ref.int8_matmul_ref(x, qt.q, qt.scale,
                                                       256), flush)
        lib_ms = time_ms(lambda: torch.matmul(x, w_lib), flush)
        b_ms, b_by = kernel_bound(*kprof.int8_matmul_cost(M, K, N, 4))
        row = {"M": M, "K": K, "N": N, "x": "float32", "ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
               "bound_by": b_by, "max_abs_err": abs_err, "rel_err": rel,
               "hi_only_rel": hi_only,
               "design": i8_design(M, K, N, torch.float32),
               "ok": rel <= F32_X_TOL and hi_only > F32_X_TOL}
        rows.append(row)
        log(f"  sLSTM gates M={M} K={K} N={N} f32 x: ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (cuBLAS f32) "
            f"bound_ms={b_ms:.4f} ({b_by}) rel_err={rel:.2e} "
            f"hi_only_rel={hi_only:.2e} {'ok' if row['ok'] else 'FAIL'}")
    del qt, w_lib, flush
    torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"int8_matmul at the sLSTM gates: {bad}")
    return rows


def train_full(cfg, seed: int, *, tag: str, rank: int, batch: tuple,
               steps: int, fwd: int, method=None, norm_keys: tuple = (),
               check_problems: bool = False) -> dict:
    """Phases 14c, 15d and 16d: ``cfg`` (full width), the
    ``qgalore`` preset at ``rank`` (``method``: the subspace method, None
    for the default), ``batch`` (B, S), ``steps`` steps (a refresh at step
    0). Each step's launches are held to what the code implies from
    ``fwd``, the ``int8_matmul`` launches of one forward (a steady step:
    the forward, every layer's recompute and ``dL/dx`` of each, one update
    a GaLore unit); losses finite; each step's peak; the gradient norm of
    each top-level leaf or subtree in ``norm_keys`` (one reached only
    through a shared block or a bridge), nonzero at every step. With
    ``check_problems``, every distinct problem of the three training
    kernels against its plain version at phase 5's bars
    (``ProblemRecorder.check``). Then one more steady step profiled; the
    step's roofline is printed under ``tag``."""
    from repro_torch.config import QGaLoreConfig, ShapeCell, TrainConfig
    from repro_torch.core.optimizers import preset
    from repro_torch.core.qgalore import flatten
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import model_zoo
    from repro_torch.train import stack
    from repro_torch.train.trainer import Trainer
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16)
    qcfg = preset("qgalore", QGaLoreConfig(
        rank=rank, **({} if method is None else {"subspace_method": method})))
    B, S = batch
    tcfg = TrainConfig(seed=seed, global_batch=B, seq_len=S, steps=steps,
                       learning_rate=1e-3, warmup_steps=1, grad_clip=1.0,
                       log_every=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tr = Trainer(bundle, tcfg, qcfg)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    units = sum(s.nbatch for s in tr.specs if s.galore)
    want = {"int8_matmul": 2 * fwd - 1, "int8_matmul_t": fwd,
            "fused_qgalore_update": units}
    names = tuple(want) + PLAIN_NAMES
    rec = ProblemRecorder(record=check_problems)
    grads_fn, norms, peaks = stack.fused_value_and_grad, [], []

    def with_norms(*a, **k):
        res = grads_fn(*a, **k)
        norms.append({n: math.sqrt(sum(float((t.float() ** 2).sum())
                                       for _, t in flatten(res[1][n])))
                      for n in norm_keys})
        return res

    first = tr.start_step

    def at_step(step):
        # each step's peak, read before the next step starts
        if step > first:
            peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
        rec.step = step

    stack.fused_value_and_grad = with_norms
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    LAUNCHES.clear()
    try:
        with rec:
            rows = run_counted(tr, tcfg.steps, names, at_step=at_step)
    finally:
        stack.fused_value_and_grad = grads_fn
    peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
    launches = dict(LAUNCHES)
    problems = []
    for r in rows:
        w = dict(want, **({"fused_qgalore_update": 0} if r["step"] == 0
                          else {}))
        got = {n: r["launches"][n] for n in w}
        if got != w:
            problems.append(f"step {r['step']} launches {got} != {w}")
        plain = {n: c for n, c in r["launches"].items() if n not in w and c}
        if plain:
            problems.append(f"step {r['step']} ran plain versions {plain}")
        if not np.isfinite(r["loss"]):
            problems.append(f"step {r['step']} loss {r['loss']}")
    if not (len(norms) == len(rows) and all(
            v > 0 and np.isfinite(v) for n in norms for v in n.values())):
        problems.append(f"gradient norms of {norm_keys}: {norms}")
    # the recorder copies each fused problem's first inputs to the host
    # inside step 1, so its steady steps start at step 2
    steady = [r["s"] for r in rows[2 if check_problems else 1:]]
    sub_s = sum(rec.sub_s.values())
    out = {"layers": cfg.num_layers, "rank": rank, "units": units,
           "subspace_method": qcfg.subspace_method, "batch": [B, S],
           "init_s": init_s, "init_peak_gib": init_peak,
           "losses": [r["loss"] for r in rows],
           "grad_norms": [r["grad_norm"] for r in rows],
           "grad_norms_of": norms,
           "refresh_step_s": rows[0]["s"], "refresh_subspace_s": sub_s,
           "median_steady_step_ms": statistics.median(steady) * 1e3,
           "tokens_per_s": B * S / statistics.median(steady),
           "peak_gib_by_step": peaks, "peak_gib": max(peaks),
           "launches": launches,
           "launches_per_steady_step": rows[-1]["launches"],
           "launches_want": want}
    shown = [{n: "%.4g" % v for n, v in d.items()} for d in norms]
    log(f"  training {cfg.name} at full width, {cfg.num_layers} layers, "
        f"rank {rank} "
        f"({qcfg.subspace_method}), {B} x {S}: {units} GaLore units; "
        f"losses {[round(x, 4) for x in out['losses']]} (ln V = "
        f"{math.log(cfg.vocab_size):.2f})"
        + (f"; gradient norms {shown}" if norm_keys else "")
        + f"; refresh step {out['refresh_step_s']:.2f} s (subspace "
        f"{sub_s:.2f} s); median steady step "
        f"{out['median_steady_step_ms']:.1f} ms; init {init_s:.1f} s, peak "
        f"{init_peak:.3f} GiB; peak by step {['%.3f' % p for p in peaks]} "
        f"GiB; a steady step launched "
        f"{ {n: out['launches_per_steady_step'][n] for n in want} } (want "
        f"{want})")
    if problems:
        raise AssertionError(f"{cfg.name} training: " + "; ".join(problems))
    out.update(profile_train_step(
        tr, f"phase {tag}'s profiled steady step ({cfg.name}, rank {rank}, "
        f"{B} x {S})"))
    out["roofline"] = step_roofline(
        tag, cfg, ShapeCell("train", S, B, "train"),
        out["median_steady_step_ms"], rank=rank,
        device_ms=out["profile_step_device_ms"])
    del tr, bundle
    gc.collect()
    torch.cuda.empty_cache()
    if check_problems:
        out.update(rec.check(tcfg.steps, tcfg.steps - 1, seed))
    return out


def phase_xlstm(seed: int) -> dict:
    """Phase 14: xlstm-125m served at full width and depth (14a), its
    answers (14b: slot tokens against ``generate`` and the bf16 decode
    against the forward inside 14a; f32 card against CPU at one group;
    the sLSTM gates at f32 x) and trained at full width and depth
    (14c)."""
    from repro_torch.config import replace
    from repro_torch.models import model_zoo
    full = model_zoo.get_config(XLSTM_ARCH)
    log(f"== phase 14: {XLSTM_ARCH} (mLSTM and sLSTM) through the slot "
        f"scheduler ({DENSE_SLOTS} slots, {DENSE_REQS} requests, prompts "
        f"{DENSE_PROMPT[0]}-{DENSE_PROMPT[1]}, {DENSE_NEW} new) and trained")
    card = nvidia_smi_line()
    log("card:", card)
    log(f"  cuts: 14a and 14c none (all {full.num_layers} layers at full "
        f"width); 14b {XLSTM_PARITY_LAYERS} layers, one group (the CPU's "
        f"plain matmuls), a {XLSTM_PARITY_PROMPT}-token prompt (two chunks "
        f"of {full.xlstm.chunk_size})")
    t0 = time.monotonic()
    serve = serve_xlstm(seed)
    split = {"14a": time.monotonic() - t0}
    log(f"  14a {XLSTM_ARCH}: {serve['tokens_per_s']:.1f} tok/s, mean TTFT "
        f"{serve['mean_ttft_s']:.3f} s, median decode dispatch "
        f"{serve['median_decode_step_ms']:.2f} ms, INT8 weights "
        f"{serve['int8_gib']:.3f} GiB, peak {serve['peak_gib']:.3f} GiB, "
        f"decode idle share {serve['device_idle_share']}, device "
        f"{serve['profile_step_device_ms']} ms a decode step, measured "
        f"launches a prefill {serve['launches_per_prefill']}, a decode "
        f"dispatch {serve['launches_per_decode_dispatch']}, pool "
        f"{serve['pool']['dtypes']} [{card}]")
    pcfg = replace(full, num_layers=XLSTM_PARITY_LAYERS)
    sens = rounding_sensitivity(pcfg, seed, XLSTM_PARITY_PROMPT)
    parity = f32_parity_dense(XLSTM_ARCH, seed, cfg=pcfg,
                              prompt=XLSTM_PARITY_PROMPT,
                              tol=max(PARITY_TOL, sens["parity_tol"]))
    parity["sensitivity"] = sens
    gates = slstm_gate_rows(seed)
    split["14b"] = time.monotonic() - t0 - split["14a"]
    training = train_full(
        full, seed, tag="14c", rank=XLSTM_RANK, batch=XLSTM_TRAIN_BATCH,
        steps=XLSTM_TRAIN_STEPS, fwd=xlstm_launches(full)["int8_matmul"])
    wall = time.monotonic() - t0
    split["14c"] = wall - split["14a"] - split["14b"]
    parts = ", ".join(f"{k} {v:.1f} s" for k, v in split.items())
    log(f"  phase 14 in {wall:.1f} s ({parts})")
    return {"serving": serve, "f32_parity": parity, "slstm_gates": gates,
            "training": training, "wall_s": wall, "split_s": split,
            "card": card,
            "cuts": {"parity": {"layers": XLSTM_PARITY_LAYERS,
                                "prompt": XLSTM_PARITY_PROMPT}}}


# ---------------------------------------------------------------------------
# phase 15: the SSM hybrid
# ---------------------------------------------------------------------------

ZAMBA_ARCH = "zamba2-2.7b"
# 15b: one superblock (5 Mamba2 blocks and a site) of the nine, for the
# CPU's plain matmuls at full width; a prompt of two SSD chunks of 256, the
# second padded
ZAMBA_PARITY_LAYERS, ZAMBA_PARITY_PROMPT = 6, 300
# 15c: a single-request prefill's site attention, d = dv = 80
ZAMBA_FLASH = (1, 512, 32, 32, 80, 80, True)
# 15d: rank 512, benchmarks/table2_memory.py's llama-1b row (it has no
# 2.7B row), the randomized subspace method; 4 x 512 tokens (two chunks);
# step 0 refreshes, steps 1-3 are steady
ZAMBA_RANK, ZAMBA_TRAIN_STEPS, ZAMBA_TRAIN_BATCH = 512, 4, (4, 512)


def zamba_launches(cfg) -> dict:
    """A prefill's or decode dispatch's ``int8_matmul`` launches:
    ``in_proj`` and ``out_proj`` of every Mamba2 block; at every site
    ``fuse``, ``wq``, ``wk``, ``wv``, ``wo``, both LoRA pairs' ``A`` and
    ``B`` (64 wide at full width), the FFN's three and ``site_out``; the
    head."""
    hc = cfg.hybrid
    return {"int8_matmul": cfg.num_layers // hc.attn_every
            * (2 * (hc.attn_every - 1) + 13) + 1}


def serve_zamba(seed: int) -> dict:
    """Phase 15a and 15b's bf16 half: zamba2-2.7b at full width and
    ``SERVE_DEPTH``'s depth through ``serve_recurrent``, drawn one superblock at a time; the pool's
    conv windows, K and V bf16 and its SSM states float32; a prefill's SSD
    chunk loops timed apart from the rest."""
    from repro_torch.models import ssm
    cfg = served_config(ZAMBA_ARCH)
    sc, hc = cfg.ssm, cfg.hybrid
    d_inner = sc.expand * cfg.d_model
    return serve_recurrent(
        cfg, seed, tag="15a", want=zamba_launches(cfg),
        describe=(f"{cfg.num_layers} layers ({cfg.num_layers // hc.attn_every}"
                  f" superblocks of {hc.attn_every - 1} Mamba2 blocks and a "
                  f"site of the shared block), d {cfg.d_model}, Mamba2 inner "
                  f"{d_inner} ({d_inner // sc.head_dim} heads of "
                  f"{sc.head_dim}, state {sc.state_dim}, conv "
                  f"{sc.conv_kernel}, chunk {sc.chunk_size}), attention "
                  f"{cfg.num_heads}/{cfg.num_kv_heads} x "
                  f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, LoRA rank "
                  f"{hc.shared_lora_rank}, vocab {cfg.vocab_size}"),
        pool_dtypes=[torch.bfloat16, torch.float32, torch.bfloat16,
                     torch.bfloat16],
        loops=(ssm, ("ssd_chunked",)), by_layer=True)


def zamba_flash(seed: int) -> dict:
    """Phase 15c: the 15a prompts prefilled, one request at a time, through
    a bundle built with ``flash_attention=True`` and through the einsum
    bundle on the same weights: each flash prefill launches
    ``flash_attention`` once a site and ``int8_matmul`` as 15a, no plain
    version; its last logits within ``BF16_PATH_TOL`` of the einsum
    route's (equal greedy tokens reported); every distinct flash problem
    against its plain version; then the d = 80 kernel at a single-request
    prefill, bf16 and f32, against its plain version and timed beside it,
    SDPA and the bound."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.models import model_zoo
    from repro_torch.serve import engine
    from repro_torch.serve.params import quantize_leaf
    cfg = served_config(ZAMBA_ARCH)
    sites = cfg.num_layers // cfg.hybrid.attn_every
    bundles = {route: model_zoo.build(cfg, device="cuda",
                                      dtype=torch.bfloat16,
                                      flash_attention=route == "flash")
               for route in ("einsum", "flash")}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = bundles["einsum"].init_params(
        gen, leaf_fn=lambda _, t: quantize_leaf(t), by_layer=True)
    want = {"einsum": zamba_launches(cfg),
            "flash": {**zamba_launches(cfg), "flash_attention": sites}}
    shapes: set = set()
    kernel = tflash.flash_attention

    def recording(q, k, v, *, causal=True):
        shapes.add((q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                    q.shape[3], v.shape[3], causal, q.dtype))
        return kernel(q, k, v, causal=causal)

    problems, errs, same, ms = [], [], [], {r: [] for r in bundles}
    flash_launches = 0
    tflash.flash_attention = recording
    try:
        for r in dense_requests(seed, cfg.vocab_size):
            batch = {"tokens": torch.from_numpy(r.tokens)[None].cuda()}
            got = {}
            for route, b in bundles.items():
                LAUNCHES.clear()
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, _ = engine.build_prefill(b, len(r.tokens) + 1)(
                    params, batch)
                torch.cuda.synchronize()
                ms[route].append((time.perf_counter() - t) * 1e3)
                n = {k: c for k, c in LAUNCHES.items() if c}
                if n != want[route]:
                    problems.append(f"{route} prefill of {len(r.tokens)} "
                                    f"tokens launched {n}, want "
                                    f"{want[route]}")
                got[route] = logits[:, -1].float()
            flash_launches += LAUNCHES["flash_attention"]
            e, f = got["einsum"], got["flash"]
            errs.append(((f - e).abs().max() / e.abs().max()).item())
            same.append(bool(torch.equal(f.argmax(-1), e.argmax(-1))))
    finally:
        tflash.flash_attention = kernel
    del params, bundles
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  flash route against the einsum route, {len(errs)} prefills "
        f"(bf16): last logits rel err {['%.2e' % e for e in errs]} "
        f"(tolerance {BF16_PATH_TOL}), greedy equal {sum(same)}/{len(same)};"
        f" median prefill ms einsum {statistics.median(ms['einsum']):.2f}, "
        f"flash {statistics.median(ms['flash']):.2f}; {flash_launches} "
        f"flash launches ({sites} a prefill)")
    if max(errs) > BF16_PATH_TOL:
        problems.append(f"flash route logits {errs}")
    out = {"prefills": len(errs), "logits_rel_err": errs,
           "greedy_equal": sum(same) / len(same),
           "median_prefill_ms": {r: statistics.median(v)
                                 for r, v in ms.items()},
           "launches": {"flash_attention": flash_launches},
           "launches_per_prefill": want["flash"]}
    out.update(check_flash_shapes(shapes, seed))
    gen = torch.Generator(device="cuda").manual_seed(seed + 25)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        row = flash_row(*ZAMBA_FLASH, dt, gen, flush)
        row["note"] = "d and dv padded to the kernel's 128-wide template"
        rows.append(row)
        log(f"  flash d=80 B={row['B']} S={row['S']} H={row['H']} "
            f"{row['dtype']}: ms={row['ms']:.4f} plain_ms="
            f"{row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
            f"(SDPA) bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
            f"tflops={row['tflops']:.1f} rel_err={row['rel_err']:.2e}"
            + (f" hi_only_rel={row['hi_only_rel']:.2e}"
               if "hi_only_rel" in row else "")
            + f" {'ok' if row['ok'] else 'FAIL'}")
        if not row["ok"]:
            problems.append(f"flash d=80 {row['dtype']}: {row}")
    del flush
    torch.cuda.empty_cache()
    out["d80_rows"] = rows
    if problems:
        raise AssertionError("phase 15c: " + "; ".join(problems))
    return out


def phase_zamba(seed: int) -> dict:
    """Phase 15: zamba2-2.7b served at full width and 3 of its 9
    superblocks (15a), its answers (15b: slot tokens against ``generate``
    and the bf16 decode against the forward inside 15a; f32 card against
    CPU at one superblock), the flash route at head_dim 80 (15c) and
    training at the same width and depth (15d)."""
    from repro_torch.config import replace
    full = served_config(ZAMBA_ARCH)
    log(f"== phase 15: {ZAMBA_ARCH} (Mamba2 and a shared attention block) "
        f"through the slot scheduler ({DENSE_SLOTS} slots, {DENSE_REQS} "
        f"requests, prompts {DENSE_PROMPT[0]}-{DENSE_PROMPT[1]}, {DENSE_NEW} "
        f"new), the flash route, and trained")
    card = nvidia_smi_line()
    log("card:", card)
    log(f"  cuts: 15a, 15c and 15d {depth_cut(ZAMBA_ARCH)} ("
        f"{full.num_layers // full.hybrid.attn_every} superblocks, full "
        f"width); 15b {ZAMBA_PARITY_LAYERS} layers, one superblock "
        f"(the CPU's plain matmuls), a {ZAMBA_PARITY_PROMPT}-token prompt "
        f"(two chunks of {full.ssm.chunk_size}, the second padded)")
    t0 = time.monotonic()
    serve = serve_zamba(seed)
    split = {"15a": time.monotonic() - t0}
    log(f"  15a {ZAMBA_ARCH}: {serve['tokens_per_s']:.1f} tok/s, mean TTFT "
        f"{serve['mean_ttft_s']:.3f} s, median decode dispatch "
        f"{serve['median_decode_step_ms']:.2f} ms, INT8 weights "
        f"{serve['int8_gib']:.3f} GiB, peak {serve['peak_gib']:.3f} GiB, "
        f"decode idle share {serve['device_idle_share']}, device "
        f"{serve['profile_step_device_ms']} ms a decode step, measured "
        f"launches a prefill {serve['launches_per_prefill']}, a decode "
        f"dispatch {serve['launches_per_decode_dispatch']}, pool "
        f"{serve['pool']['dtypes']} [{card}]")
    pcfg = replace(full, num_layers=ZAMBA_PARITY_LAYERS)
    sens = rounding_sensitivity(pcfg, seed, ZAMBA_PARITY_PROMPT)
    parity = f32_parity_dense(ZAMBA_ARCH, seed, cfg=pcfg,
                              prompt=ZAMBA_PARITY_PROMPT,
                              tol=max(PARITY_TOL, sens["parity_tol"]))
    parity["sensitivity"] = sens
    split["15b"] = time.monotonic() - t0 - sum(split.values())
    flash = zamba_flash(seed)
    split["15c"] = time.monotonic() - t0 - sum(split.values())
    training = train_full(
        full, seed, tag="15d", rank=ZAMBA_RANK, batch=ZAMBA_TRAIN_BATCH,
        steps=ZAMBA_TRAIN_STEPS, method="randomized",
        fwd=zamba_launches(full)["int8_matmul"], norm_keys=("shared_attn",))
    wall = time.monotonic() - t0
    split["15d"] = wall - sum(split.values())
    parts = ", ".join(f"{k} {v:.1f} s" for k, v in split.items())
    log(f"  phase 15 in {wall:.1f} s ({parts})")
    return {"serving": serve, "f32_parity": parity, "flash": flash,
            "training": training, "wall_s": wall, "split_s": split,
            "card": card,
            "cuts": {"serving": full.num_layers,
                     "parity": {"layers": ZAMBA_PARITY_LAYERS,
                                "prompt": ZAMBA_PARITY_PROMPT}}}


# ---------------------------------------------------------------------------
# phase 16: the encoder-decoder
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-medium"
# 16a: two batches of 4 requests through ``generate``: 512 frames each, a
# decoder prompt of 128 tokens (``encdec_prompt``), 32 new tokens, a 256
# window
ENCDEC_BATCHES, ENCDEC_ROWS, ENCDEC_FRAMES = 2, 4, 512
ENCDEC_NEW, ENCDEC_WINDOW = 32, 256
# 16b: 2 + 2 layers at full width (the head at V 256206 included), the
# CPU's plain matmuls; 2 rows of 256 frames, a 64-token prompt, 3 steps
ENCDEC_PARITY_LAYERS, ENCDEC_PARITY_ROWS = 2, 2
ENCDEC_PARITY_FRAMES, ENCDEC_PARITY_PROMPT = 256, 64
# 16c: the decoder's self-attention at a 16a prefill, d = dv = 64; the
# flash route's prefill logits against the einsum route's (of
# max|logits|, bf16)
ENCDEC_FLASH = (4, 128, 16, 16, 64, 64, True)
FLASH_ROUTE_TOL = 5e-2
# 16d: rank 256, benchmarks/table2_memory.py's d = 1024 row (llama-350m,
# the nearest); the randomized subspace method; 4 x 512 frames (128
# decoder tokens); step 0 refreshes, steps 1-3 are steady
ENCDEC_RANK, ENCDEC_TRAIN_STEPS, ENCDEC_TRAIN_BATCH = 256, 4, (4, 512)


def encdec_launches(cfg, rows: int, frames: int, prompt: int,
                    decode: bool) -> Counter:
    """``int8_matmul`` launches of a prefill or a decode step by M: 7 an
    encoder layer at M = rows x frames; a decoder layer's self q, k, v, o,
    cross q, o and the FFN's three at M = rows x prompt (rows at decode),
    its cross k and v on the memory at rows x frames (every decode step
    too, as the reference); the head at M = rows (the last position)."""
    n_enc = cfg.num_encoder_layers or cfg.num_layers
    n_dec = cfg.num_layers
    mem, tok = rows * frames, rows if decode else rows * prompt
    want = Counter({mem: 2 * n_dec})
    want[tok] += 9 * n_dec
    want[rows] += 1
    if not decode:
        want[mem] += 7 * n_enc
    return want


def encdec_prompt(bundle, frames: int) -> int:
    """The decoder's tokens for ``frames`` frames, as the bundle's
    ``input_specs`` sets them (``max(frames // DEC_RATIO, 16)``)."""
    from repro_torch.config import ShapeCell
    cell = ShapeCell("prompt", frames, 1, "prefill")
    return bundle.input_specs(cell)["tokens"][0][1]


def encdec_inputs(seed: int, cfg, rows: int, frames: int, tokens: int,
                  n: int = 1, salt: int = 16) -> list:
    """``n`` batches of ``rows`` requests drawn from ``seed`` on the host:
    ``frames`` (rows, frames, d) float32, the stub frontend's ``normal *
    0.5``, and decoder tokens (rows, tokens)."""
    rng = np.random.default_rng(seed + salt)
    return [{"frames": torch.from_numpy((rng.standard_normal(
                (rows, frames, cfg.d_model)) * 0.5).astype(np.float32)),
             "tokens": torch.from_numpy(rng.integers(
                 1, cfg.vocab_size, size=(rows, tokens)).astype(np.int32))}
            for _ in range(n)]


def encdec_decode_vs_forward(bundle, params, seed: int, steps: int = 4
                             ) -> list:
    """16a's bf16 check: one request's prefill (512 frames, 128 tokens),
    then ``steps`` teacher-forced decode steps, each step's logits
    against the full forward's last logits at that length (relative to
    max|forward|)."""
    from repro_torch.models import base
    from repro_torch.serve import engine
    prompt = encdec_prompt(bundle, ENCDEC_FRAMES)
    b = {k: v.cuda() for k, v in encdec_inputs(
        seed, bundle.cfg, 1, ENCDEC_FRAMES, prompt + steps, salt=17)[0]
        .items()}

    @torch.no_grad()
    def full(upto):
        carry, ctx = bundle.embed(params, {"frames": b["frames"],
                                           "tokens": b["tokens"][:, :upto]})
        carry = base.run_segments(bundle, params, carry, ctx)
        return bundle.head_logits(params, carry)[:, -1].float()

    def rel(a, w):
        return ((a.float() - w).abs().max() / w.abs().max()).item()

    logits, state = engine.build_prefill(bundle, prompt + steps + 1)(
        params, {"frames": b["frames"], "tokens": b["tokens"][:, :prompt]})
    errs = [rel(logits[:, -1], full(prompt))]
    decode = engine.build_decode(bundle)
    for t in range(prompt, prompt + steps):
        logits, state = decode(params, state, b["tokens"][:, t: t + 1])
        errs.append(rel(logits[:, -1], full(t + 1)))
    return errs


def encdec_cross_kv(bundle, params, memory) -> dict:
    """A decode step's cross-attention K and V (2 a decoder layer, on the
    whole memory, as the reference recomputes them) back to back on the
    run's weights between one pair of events, beside cuBLAS bf16 on the
    same weights dequantized and the bound."""
    from repro_torch.analysis.roofline import kernel_bound
    from repro_torch.kernels import profile as kprof
    from repro_torch.core import quant
    from repro_torch.models.base import layer_params
    from repro_torch.models.layers import dense
    cross = params["seg1_decoder"]["cross_attn"]
    ws = [layer_params(cross, i)[k] for i in range(bundle.cfg.num_layers)
          for k in ("wk", "wv")]
    x = memory.reshape(-1, memory.shape[-1])
    ms, host = sequence_ms(lambda: [dense(x, w, torch.bfloat16)
                                    for w in ws])
    deq = [quant.dequantize(w, torch.bfloat16) for w in ws]
    lib_ms, _ = sequence_ms(lambda: [x @ w for w in deq])
    M, K = x.shape
    N = ws[0].q.shape[1]
    b_ms, by = kernel_bound(*kprof.int8_matmul_cost(M, K, N,
                                                    x.element_size()))
    del deq
    out = {"calls": len(ws), "M": M, "K": K, "N": N, "ms": ms,
           "host_ms": host, "library_ms": lib_ms,
           "bound_ms": b_ms * len(ws), "bound_by": by}
    log(f"  a decode step's {len(ws)} cross K/V calls (M {M}, K {K}, N "
        f"{N}, bf16) back to back: {ms:.3f} ms device ({host:.3f} ms to "
        f"enqueue), cuBLAS bf16 {lib_ms:.3f} ms, bound "
        f"{out['bound_ms']:.3f} ms ({by})")
    return out


def encdec_stepper(bundle, params, batch):
    """A decode step of ``batch`` (rows in flight from its prefill and a
    first decode step, outside any count), each call one more step."""
    from repro_torch.serve import engine
    logits, st = engine.build_prefill(bundle, ENCDEC_WINDOW)(params, batch)
    decode = engine.build_decode(bundle)
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    state = [decode(params, st, tok)[1]]

    def step():
        state[0] = decode(params, state[0], tok)[1]
    return step


def serve_encdec(seed: int, bundle, params) -> dict:
    """Phase 16a: seamless-m4t-medium at full width and depth through
    ``engine.generate``, two batches of 4 requests. A counted run, each
    prefill and decode step synchronized at its ends: every prefill's and
    decode step's ``int8_matmul`` launches held to the code's count by M,
    no plain version, the decode step's ms and the TTFT. Tokens/s from a
    second run with no wrapper and no synchronize inside ``generate``. The
    encoder's share of a prefill from prefills of their own (a synchronize
    at the bridge). Then the slot and paged schedulers refused by name;
    the bf16 decode against the forward, a profiled decode step, the
    cross K/V calls timed apart and every distinct problem against its
    plain version."""
    from repro_torch.config import ShapeCell
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.serve import engine
    from repro_torch.serve.scheduler import make_scheduler
    cfg = bundle.cfg
    problems = []
    refused = {}
    for backend, error, name in (
            ("auto", NotImplementedError, "decode_extras"),
            ("slot", NotImplementedError, "decode_extras"),
            ("paged", ValueError, "chunk-append")):
        try:
            make_scheduler(bundle, params, backend=backend, num_slots=4,
                           max_len=ENCDEC_WINDOW, device="cuda")
            problems.append(f"make_scheduler({backend!r}) took the bundle")
        except error as e:
            refused[backend] = str(e)
            if name not in str(e):
                problems.append(f"{backend}: {e}")
    log(f"  schedulers refuse the bundle by name: {refused}")
    prompt = encdec_prompt(bundle, ENCDEC_FRAMES)
    batches = encdec_inputs(seed, cfg, ENCDEC_ROWS, ENCDEC_FRAMES, prompt,
                            n=ENCDEC_BATCHES)
    want = {k: encdec_launches(cfg, ENCDEC_ROWS, ENCDEC_FRAMES, prompt,
                               k == "decode") for k in ("prefill", "decode")}
    engine.generate(bundle, params, batches[0], steps=2,
                    max_len=ENCDEC_WINDOW, device="cuda")     # warm-up
    ms_log, shapes = [], set()
    calls = {"prefill": [], "decode": []}
    kernel, bp, bd = ti8.int8_matmul, engine.build_prefill, \
        engine.build_decode

    def recording(x, q, scale, block=256, p=None):
        shapes.add((x.shape[0], q.shape[0], q.shape[1], x.dtype))
        ms_log.append(x.shape[0])
        return kernel(x, q, scale, block, p)

    def wrap(kind, fn):
        def run(*a):
            i0 = len(ms_log)
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = fn(*a)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            calls[kind].append({"ms": (t1 - t) * 1e3,
                                "M": Counter(ms_log[i0:]), "end": t1})
            return res
        return run

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ti8.int8_matmul = recording
    engine.build_prefill = lambda *a, **k: wrap("prefill", bp(*a, **k))
    engine.build_decode = lambda *a, **k: wrap("decode", bd(*a, **k))
    LAUNCHES.clear()
    ttft, counted_s = [], []
    try:
        for b in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, st = engine.generate(bundle, params, b, steps=ENCDEC_NEW - 1,
                                    max_len=ENCDEC_WINDOW, device="cuda")
            torch.cuda.synchronize()
            counted_s.append(time.perf_counter() - t)
            ttft.append(calls["prefill"][-1]["end"] - t)
    finally:
        ti8.int8_matmul = kernel
        engine.build_prefill, engine.build_decode = bp, bd
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    memory = st.extras["memory"]
    for kind, rows in calls.items():
        bad = [dict(r["M"]) for r in rows if r["M"] != want[kind]]
        if bad:
            problems.append(f"{kind}: {len(bad)} of {len(rows)} launched "
                            f"{bad[0]} by M, want {dict(want[kind])}")
    if any(c and (n.endswith("_ref") or n.startswith("deq_"))
           for n, c in counts.items()):
        problems.append(f"plain versions ran: {counts}")
    # tokens/s: ``generate`` as it ships, timed from outside alone
    walls, n_tok = [], 0
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks, _ = engine.generate(bundle, params, b, steps=ENCDEC_NEW - 1,
                                  max_len=ENCDEC_WINDOW, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        n_tok += toks.numel()
    # the encoder's share: prefills of their own, a synchronize at the
    # bridge
    enc, dec = bundle.segments
    marks = {}

    def timed_bridge(p, carry, ctx):
        torch.cuda.synchronize()
        marks["bridge"] = time.perf_counter()
        return dec.pre(p, carry, ctx)

    timed = dataclasses.replace(bundle, segments=(
        enc, dataclasses.replace(dec, pre=timed_bridge)))
    prefill = engine.build_prefill(timed, ENCDEC_WINDOW)
    pre_ms, enc_ms = [], []
    for b in batches:
        b = {k: v.cuda() for k, v in b.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill(params, b)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t) * 1e3)
        enc_ms.append((marks["bridge"] - t) * 1e3)
    small = min(want["decode"])
    out = {"tokens_per_s": n_tok / sum(walls), "tokens": n_tok,
           "wall_s": sum(walls),
           "counted_tokens_per_s": n_tok / sum(counted_s),
           "mean_ttft_s": float(np.mean(ttft)),
           "median_decode_step_ms": statistics.median(
               r["ms"] for r in calls["decode"]),
           "counted_prefill_ms": [r["ms"] for r in calls["prefill"]],
           "prefill_ms": pre_ms, "encoder_ms": enc_ms,
           "encoder_share": [e / p for e, p in zip(enc_ms, pre_ms)],
           "dispatches": {k: len(v) for k, v in calls.items()},
           "launches": counts,
           "launches_per_prefill": sum(calls["prefill"][0]["M"].values()),
           "launches_per_decode_step": sum(calls["decode"][0]["M"].values()),
           "launches_by_m": {k: {str(m): n for m, n in sorted(
               calls[k][0]["M"].items())} for k in calls},
           "launches_want_by_m": {k: {str(m): n for m, n in sorted(
               w.items())} for k, w in want.items()},
           "decode_small_m": want["decode"][small],
           "peak_gib": peak, "refused": refused,
           "batches": [ENCDEC_ROWS, ENCDEC_FRAMES, prompt, ENCDEC_NEW]}
    log(f"  {n_tok} tokens in {out['wall_s']:.2f} s -> "
        f"{out['tokens_per_s']:.1f} tok/s (generate alone); counted run: "
        f"{out['counted_tokens_per_s']:.1f} tok/s, mean TTFT "
        f"{out['mean_ttft_s']:.3f} s, median decode step "
        f"{out['median_decode_step_ms']:.2f} ms, prefills "
        f"{['%.1f' % x for x in out['counted_prefill_ms']]} ms; prefills "
        f"timed apart {['%.1f' % x for x in pre_ms]} ms, the encoder (and "
        f"embed) {['%.1f' % x for x in enc_ms]} ms of them; peak "
        f"{peak:.3f} GiB; launches {counts}; a prefill by M "
        f"{out['launches_by_m']['prefill']}, a decode step "
        f"{out['launches_by_m']['decode']} (want "
        f"{out['launches_want_by_m']})")
    out["cross_kv"] = encdec_cross_kv(bundle, params, memory)
    out.update(profile_decode(encdec_stepper(
        bundle, params, {k: v.cuda() for k, v in batches[0].items()})))
    out["roofline"] = step_roofline(
        "16a", cfg, ShapeCell("serve", prompt + ENCDEC_NEW, ENCDEC_ROWS,
                              "decode"), out["median_decode_step_ms"],
        tokens_per_s=out["tokens_per_s"],
        device_ms=out["profile_step_device_ms"])
    errs = encdec_decode_vs_forward(bundle, params, seed)
    log(f"  bf16 decode against the full forward (prefill, then 4 "
        f"teacher-forced steps), rel err {['%.2e' % e for e in errs]} "
        f"(tolerance {BF16_PATH_TOL})")
    if max(errs) > BF16_PATH_TOL:
        problems.append(f"decode against forward {errs}")
    out["decode_vs_forward_rel"] = errs
    out.update(check_shapes(shapes, seed))
    if problems:
        raise AssertionError("phase 16a: " + "; ".join(problems))
    return out


def f32_parity_encdec(seed: int, cfg, tol: float) -> dict:
    """Phase 16b: ``cfg`` (2 + 2 layers at full width) at f32, the same
    INT8 codes on the card and the CPU; 2 rows of 256 frames, a prefill of
    64 decoder tokens and 3 teacher-forced decode steps: the card's logits
    within ``tol`` of the CPU's and the same greedy tokens; the card
    launches ``int8_matmul``, the CPU the plain version."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import model_zoo
    from repro_torch.serve import engine
    from repro_torch.serve.params import quantize_leaf
    gpu = model_zoo.build(cfg, device="cuda", dtype=torch.float32)
    cpu = model_zoo.build(cfg, device="cpu", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    p_gpu = gpu.init_params(gen, leaf_fn=lambda _, t: quantize_leaf(t),
                            by_layer=True)
    p_cpu = to_cpu(p_gpu)
    P = ENCDEC_PARITY_PROMPT
    b = encdec_inputs(seed, cfg, ENCDEC_PARITY_ROWS, ENCDEC_PARITY_FRAMES,
                      P + 3, salt=13)[0]
    out = {}
    for name, bundle, params in (("cpu", cpu, p_cpu), ("gpu", gpu, p_gpu)):
        dev = bundle.device
        frames, t = b["frames"].to(dev), b["tokens"].to(dev)
        LAUNCHES.clear()
        logits, state = engine.build_prefill(bundle, P + 4)(
            params, {"frames": frames, "tokens": t[:, :P]})
        got = [logits[:, -1]]
        decode = engine.build_decode(bundle)
        for i in range(P, P + 3):
            logits, state = decode(params, state, t[:, i: i + 1])
            got.append(logits[:, -1])
        out[name] = ([g.float().cpu() for g in got], dict(LAUNCHES))
    (l_c, n_c), (l_g, n_g) = out["cpu"], out["gpu"]
    rel = max(((g - c).abs().max() / c.abs().max()).item()
              for g, c in zip(l_g, l_c))
    same = all(torch.equal(g.argmax(-1), c.argmax(-1))
               for g, c in zip(l_g, l_c))
    log(f"  {cfg.name} f32, {cfg.num_encoder_layers} + {cfg.num_layers} "
        f"layers, card against CPU: rel err {rel:.2e} (tolerance "
        f"{tol:.2e}) over the prefill of {P} tokens on "
        f"{ENCDEC_PARITY_FRAMES} frames and 3 decode steps, "
        f"{ENCDEC_PARITY_ROWS} rows, greedy tokens "
        f"{'equal' if same else 'DIFFER'}; launches card {n_g} CPU {n_c}")
    problems = []
    if set(n_g) != {"int8_matmul"}:
        problems.append(f"card launches {n_g}")
    if set(n_c) != {"deq_matmul"}:
        problems.append(f"CPU launches {n_c}")
    if rel > tol:
        problems.append(f"rel err {rel:.2e}")
    if not same:
        problems.append("greedy tokens differ")
    del p_gpu, p_cpu, gpu, cpu
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("phase 16b: " + "; ".join(problems))
    return {"rel_err": rel, "same_greedy": same, "launches_card": n_g,
            "launches_cpu": n_c}


def encdec_flash(seed: int, bundle, params) -> dict:
    """Phase 16c: 16a's batches prefilled through a bundle built with
    ``flash_attention=True`` and through the einsum bundle on the same
    weights: each flash prefill launches ``flash_attention`` once a
    decoder layer (the encoder's attention is not causal and
    cross-attention's queries are not aligned, so neither takes it) and
    ``int8_matmul`` as 16a, no plain version; its last logits within
    ``FLASH_ROUTE_TOL`` of the einsum route's (greedy tokens reported);
    every distinct flash problem against its plain version; then the d =
    64 kernel at 16a's prefill shape, bf16 and f32, against its plain
    version and timed beside it, SDPA and the bound."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.models import model_zoo
    from repro_torch.serve import engine
    cfg = bundle.cfg
    bundles = {"einsum": bundle,
               "flash": model_zoo.build(cfg, device="cuda",
                                        dtype=torch.bfloat16,
                                        flash_attention=True)}
    prompt = encdec_prompt(bundle, ENCDEC_FRAMES)
    i8 = sum(encdec_launches(cfg, ENCDEC_ROWS, ENCDEC_FRAMES, prompt,
                             False).values())
    want = {"einsum": {"int8_matmul": i8},
            "flash": {"int8_matmul": i8, "flash_attention": cfg.num_layers}}
    shapes: set = set()
    kernel = tflash.flash_attention

    def recording(q, k, v, *, causal=True):
        shapes.add((q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                    q.shape[3], v.shape[3], causal, q.dtype))
        return kernel(q, k, v, causal=causal)

    problems, errs, same, ms = [], [], [], {r: [] for r in bundles}
    flash_launches = 0
    tflash.flash_attention = recording
    try:
        for b in encdec_inputs(seed, cfg, ENCDEC_ROWS, ENCDEC_FRAMES, prompt,
                               n=ENCDEC_BATCHES):
            b = {k: v.cuda() for k, v in b.items()}
            got = {}
            for route, bb in bundles.items():
                LAUNCHES.clear()
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, _ = engine.build_prefill(bb, ENCDEC_WINDOW)(params, b)
                torch.cuda.synchronize()
                ms[route].append((time.perf_counter() - t) * 1e3)
                n = {k: c for k, c in LAUNCHES.items() if c}
                if n != want[route]:
                    problems.append(f"{route} prefill launched {n}, want "
                                    f"{want[route]}")
                got[route] = logits[:, -1].float()
            flash_launches += LAUNCHES["flash_attention"]
            e, f = got["einsum"], got["flash"]
            errs.append(((f - e).abs().max() / e.abs().max()).item())
            same.append(torch.equal(f.argmax(-1), e.argmax(-1)))
    finally:
        tflash.flash_attention = kernel
    log(f"  flash route against the einsum route, {len(errs)} prefills of "
        f"{ENCDEC_ROWS} rows (bf16): last logits rel err "
        f"{['%.2e' % e for e in errs]} (tolerance {FLASH_ROUTE_TOL}), greedy "
        f"rows equal {sum(same)}/{len(same)} batches; median prefill ms "
        f"einsum {statistics.median(ms['einsum']):.2f}, flash "
        f"{statistics.median(ms['flash']):.2f}; {flash_launches} flash "
        f"launches ({cfg.num_layers} a prefill)")
    if max(errs) > FLASH_ROUTE_TOL:
        problems.append(f"flash route logits {errs}")
    out = {"prefills": len(errs), "logits_rel_err": errs,
           "greedy_equal": sum(same) / len(same),
           "median_prefill_ms": {r: statistics.median(v)
                                 for r, v in ms.items()},
           "launches": {"flash_attention": flash_launches},
           "launches_per_prefill": want["flash"]}
    out.update(check_flash_shapes(shapes, seed))
    gen = torch.Generator(device="cuda").manual_seed(seed + 26)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = []
    for dt in (torch.bfloat16, torch.float32):
        row = flash_row(*ENCDEC_FLASH, dt, gen, flush)
        row["note"] = "d and dv at the kernel's 64-wide template, no padding"
        rows.append(row)
        log(f"  flash d=64 B={row['B']} S={row['S']} H={row['H']} "
            f"{row['dtype']}: ms={row['ms']:.4f} plain_ms="
            f"{row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
            f"(SDPA) bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
            f"tflops={row['tflops']:.1f} rel_err={row['rel_err']:.2e}"
            + (f" hi_only_rel={row['hi_only_rel']:.2e}"
               if "hi_only_rel" in row else "")
            + f" {'ok' if row['ok'] else 'FAIL'}")
        if not row["ok"]:
            problems.append(f"flash d=64 {row['dtype']}: {row}")
    del flush, bundles
    torch.cuda.empty_cache()
    out["d64_rows"] = rows
    if problems:
        raise AssertionError("phase 16c: " + "; ".join(problems))
    return out


def phase_encdec(seed: int) -> dict:
    """Phase 16: seamless-m4t-medium served through ``generate`` at full
    width and depth (16a), its f32 answers against the CPU at 2 + 2
    layers (16b), the flash route (16c) and training at full width and
    depth (16d)."""
    from repro_torch.config import replace
    from repro_torch.models import model_zoo
    from repro_torch.serve.params import quantize_leaf
    cfg = model_zoo.get_config(ENCDEC_ARCH)
    log(f"== phase 16: {ENCDEC_ARCH} (encoder-decoder, the audio frontend "
        f"stubbed) through generate ({ENCDEC_BATCHES} batches of "
        f"{ENCDEC_ROWS} requests, {ENCDEC_FRAMES} frames, "
        f"{ENCDEC_NEW} new), the flash route, and trained")
    card = nvidia_smi_line()
    log("card:", card)
    log(f"  cuts: 16a, 16c and 16d none ({cfg.num_encoder_layers} + "
        f"{cfg.num_layers} layers at full width); 16b "
        f"{ENCDEC_PARITY_LAYERS} + {ENCDEC_PARITY_LAYERS} layers (the CPU's "
        f"plain matmuls), {ENCDEC_PARITY_ROWS} rows of "
        f"{ENCDEC_PARITY_FRAMES} frames, a {ENCDEC_PARITY_PROMPT}-token "
        f"prompt")
    t0 = time.monotonic()
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = bundle.init_params(gen, leaf_fn=lambda _, t: quantize_leaf(t),
                                by_layer=True)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    st = tree_stats(params)
    want_params = model_zoo.count_params(cfg)
    log(f"  {cfg.name}: {cfg.num_encoder_layers} + {cfg.num_layers} layers, "
        f"d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} x "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: "
        f"{st['params']:,} parameters ({want_params:,} counted on the meta "
        f"device), INT8 codes and scales {st['int8_bytes'] / 2**30:.3f} GiB,"
        f" float {st['float_bytes'] / 2**20:.3f} MiB; drawn and quantized "
        f"in {init_s:.2f} s, peak {init_peak:.3f} GiB")
    if st["params"] != want_params:
        raise AssertionError(f"phase 16a: {st['params']} parameters drawn, "
                             f"{want_params} counted")
    serve = serve_encdec(seed, bundle, params)
    serve.update(params=st["params"], int8_gib=st["int8_bytes"] / 2 ** 30,
                 init_s=init_s, init_peak_gib=init_peak)
    log(f"  16a {ENCDEC_ARCH}: {serve['tokens_per_s']:.1f} tok/s, mean TTFT "
        f"{serve['mean_ttft_s']:.3f} s, median decode step "
        f"{serve['median_decode_step_ms']:.2f} ms, encoder share of a "
        f"prefill {['%.3f' % x for x in serve['encoder_share']]}, INT8 "
        f"weights {serve['int8_gib']:.3f} GiB, peak {serve['peak_gib']:.3f} "
        f"GiB, decode idle share {serve['device_idle_share']}, device "
        f"{serve['profile_step_device_ms']} ms a decode step, launches a "
        f"prefill {serve['launches_per_prefill']}, a decode step "
        f"{serve['launches_per_decode_step']} [{card}]")
    split = {"16a": time.monotonic() - t0}
    flash = encdec_flash(seed, bundle, params)
    B, S = ENCDEC_TRAIN_BATCH
    train_prompt = encdec_prompt(bundle, S)
    fwd = sum(encdec_launches(cfg, B, S, train_prompt, False).values())
    split["16c"] = time.monotonic() - t0 - sum(split.values())
    del params, bundle
    gc.collect()
    torch.cuda.empty_cache()
    pcfg = replace(cfg, num_layers=ENCDEC_PARITY_LAYERS,
                   num_encoder_layers=ENCDEC_PARITY_LAYERS)
    sens = rounding_sensitivity(pcfg, seed, ENCDEC_PARITY_PROMPT,
                                frames=ENCDEC_PARITY_FRAMES)
    parity = f32_parity_encdec(seed, pcfg,
                               tol=max(PARITY_TOL, sens["parity_tol"]))
    parity["sensitivity"] = sens
    split["16b"] = time.monotonic() - t0 - sum(split.values())
    training = train_full(
        cfg, seed, tag="16d", rank=ENCDEC_RANK, batch=ENCDEC_TRAIN_BATCH,
        steps=ENCDEC_TRAIN_STEPS, method="randomized", fwd=fwd,
        norm_keys=("frame_norm", "enc_final_norm"), check_problems=True)
    training.update(layers=[cfg.num_encoder_layers, cfg.num_layers],
                    decoder_tokens=train_prompt)
    wall = time.monotonic() - t0
    split["16d"] = wall - sum(split.values())
    parts = ", ".join(f"{k} {v:.1f} s" for k, v in split.items())
    log(f"  phase 16 in {wall:.1f} s ({parts})")
    return {"serving": serve, "f32_parity": parity, "flash": flash,
            "training": training, "wall_s": wall, "split_s": split,
            "card": card,
            "cuts": {"parity": {"layers": [ENCDEC_PARITY_LAYERS] * 2,
                                "rows": ENCDEC_PARITY_ROWS,
                                "frames": ENCDEC_PARITY_FRAMES,
                                "prompt": ENCDEC_PARITY_PROMPT}}}


def phase_flash(seed: int) -> tuple:
    """Phase 6 alone (``--only 6``): 6a, 6b and 6c."""
    return (phase_flash_kernels(seed), phase_serving(seed, flash=True),
            phase_parity(seed, flash=True))


def phase_finetune(seed: int) -> dict:
    """Phase 9 alone (``--only 9``): 9a and 9b."""
    return {"cli": phase_finetune_cli(seed),
            "llama_7b": phase_finetune_7b(seed)}


DP_ARCH = "llama-1b"
DP_LAYERS = 4          # of 24: splits over 2 ranks, and keeps the phase short
DP_WORLD = 2           # ranks, both on cuda:0 (gloo: NCCL refuses two a card)
DP_STEPS = 4           # step 0 refreshes every layer (exact SVD), 1-3 steady
DP_SAVE_AFTER = 2      # 17c: rank 0 saves 17b's state after this step
DP_WAIT_S = 300.0      # rank 0's longest wait for the parent's 17c
DP_LOSS_BAND = 1e-3    # the reference's band (test_dp_compress_parity)
DP_STEP0_TOL = 1e-5    # step 0 (relative): each row's forward is the one
                       # process's, only the ranks' mean sums otherwise
DP_NAMES = TRAIN_KERNELS + PLAIN_NAMES


def dp_config():
    from repro_torch.config import replace
    from repro_torch.models import model_zoo
    return replace(model_zoo.get_config(DP_ARCH), num_layers=DP_LAYERS)


def dp_trainer(bundle, seed: int, group=None, zero: bool = False,
               checkpoint_dir: str = ""):
    from repro_torch.config import QGaLoreConfig, TrainConfig
    from repro_torch.core.optimizers import preset
    from repro_torch.train.trainer import Trainer
    qcfg = preset("qgalore", QGaLoreConfig(rank=512, compress_dp_grads=True))
    tcfg = TrainConfig(seed=seed, global_batch=8, seq_len=256,
                       steps=DP_STEPS, learning_rate=1e-3, warmup_steps=2,
                       grad_clip=1.0, log_every=0,
                       checkpoint_dir=checkpoint_dir, async_checkpoint=False)
    return Trainer(bundle, tcfg, qcfg, group=group, zero_shard=zero)


def dp_run(tr, comm=None, rec=None, save_dir: str = "", saved=None,
           steps: int = DP_STEPS) -> dict:
    """``tr``'s ``steps`` steps, each with its loss, host ms (less a save
    made in its hook), its launches of ``DP_NAMES``, its collectives (calls, bytes,
    s), its subspace seconds, the device memory allocated as it starts and
    its peak; the similarities the controller was fed, and the
    projections' codes after step 0. With ``save_dir`` the state after
    step ``DP_SAVE_AFTER`` is saved there (rank 0 writes; its peak is
    apart from the steps') and ``saved``, an event, is set after it."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.train.checkpoint import CheckpointManager
    snaps, colls, saves, sims, proj = {}, {}, {}, {}, {}
    sub_s = getattr(rec, "sub_s", None)
    peaks, resident = {}, {}
    observe = tr.controller.observe

    def seen(step, masks, s, r):
        sims.update({k: np.asarray(v).copy() for k, v in s.items()})
        return observe(step, masks, s, r)

    def hook(step):
        torch.cuda.synchronize()
        # the peak since the last hook: the trainer's set-up before step
        # 0, else the step before this one
        peaks[step - 1] = torch.cuda.max_memory_allocated() / 2 ** 30
        resident[step] = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        snaps[step] = Counter(LAUNCHES)
        if comm is not None:
            colls[step] = {k: list(v) for k, v in comm.stats.items()}
            comm.reset_stats()
        if rec is not None:
            rec.step = step
        if step == 1 and tr.zero is None:
            proj.update({i: P.map(lambda t: t.cpu()) for i, P in
                         enumerate(tr.state.opt.proj) if P is not None})
        if save_dir and step == DP_SAVE_AFTER + 1:
            t = time.perf_counter()
            tr.mgr = CheckpointManager(save_dir, async_save=False)
            tr.save(DP_SAVE_AFTER)
            tr.mgr = None
            saves[step] = time.perf_counter() - t
            if saved is not None:
                saved.set()
            comm.reset_stats()
            torch.cuda.synchronize()
            peaks["save"] = torch.cuda.max_memory_allocated() / 2 ** 30
            torch.cuda.reset_peak_memory_stats()

    tr.controller.observe = seen
    tr.fault_hook = hook
    try:
        hist = tr.run(steps)
    finally:
        tr.fault_hook = None
        tr.controller.observe = observe
    hook(steps)
    rows = []
    for h in hist:
        s = h["step"]
        rows.append({
            "step": s, "loss": h["loss"], "grad_norm": h["grad_norm"],
            "ms": (h["dt"] - saves.get(s, 0.0)) * 1e3,
            "save_s": saves.get(s),
            "launches": {n: snaps[s + 1][n] - snaps[s][n] for n in DP_NAMES},
            "collectives": colls.get(s + 1, {}),
            "peak_gib": peaks[s], "resident_gib": resident[s],
            "subspace_s": None if sub_s is None else sub_s.get(s, 0.0)})
    return {"rows": rows, "sims": sims, "proj": proj,
            "setup_peak_gib": peaks[-1], "save_peak_gib": peaks.get("save")}


def dp_proj_agreement(got: dict, want: dict) -> tuple:
    """Two refreshes' INT4 projections (by leaf): the share of codes that
    differ as stored; with each column of ``got`` given the sign of
    ``want``'s (a singular vector's sign is the solver's choice), the
    share of entries more than one of ``want``'s quanta apart, and the
    smallest column |cos|; the smallest subspace overlap ``|P_got^T
    P_want|_F^2 / r`` of a layer."""
    from repro_torch.core import quant
    raw = diff = 0.0
    cos_min = overlap_min = 1.0
    for i, w in want.items():
        g = got[i]
        raw = max(raw, float((g.q != w.q).float().mean()))
        pg = quant.dequantize(g, torch.float32)
        pw = quant.dequantize(w, torch.float32)
        r = pw.shape[-1]
        quantum = w.scale.repeat_interleave(w.block, dim=-1)[..., :r]
        pg, pw, quantum = (t.reshape((-1,) + tuple(t.shape[-2:]))
                           for t in (pg, pw, quantum))
        dots = (pg * pw).sum(-2)
        norms = pg.norm(dim=-2) * pw.norm(dim=-2)
        cos_min = min(cos_min, float((dots.abs() / norms).min()))
        signed = pg * torch.where(dots < 0, -1.0, 1.0).unsqueeze(-2)
        diff = max(diff, float(((signed - pw).abs() > quantum)
                               .float().mean()))
        ov = (pg.transpose(-1, -2) @ pw).pow(2).sum((-2, -1)) / (
            pg.norm(dim=-2).pow(2).mean(-1) * pw.norm(dim=-2).pow(2).mean(-1)
            * r)
        overlap_min = min(overlap_min, float(ov.min()))
    return raw, diff, cos_min, overlap_min


def dp_warm_up() -> dict:
    """A new process's first calls, each on a few elements and timed: the
    quantization of a layout on the meta device (the trainer's first; it
    gives the layout from the shape alone, so no meta ``abs`` imports
    ``torch._dynamo``, ~900 modules), then on the card the CUDA context,
    a matmul, the QR of the trainer's first projections and the SVD of
    the exact refresh."""
    from repro_torch.core import quant
    secs, t = {}, time.monotonic()
    for name, fn in (
            ("meta", lambda: quant.quantize_blockwise(
                torch.empty(8, 256, device="meta"), symmetric=True)),
            ("context", lambda: torch.ones(8, device="cuda")),
            ("matmul", lambda: torch.ones(8, 8, device="cuda",
                                          dtype=torch.bfloat16) @
             torch.ones(8, 8, device="cuda", dtype=torch.bfloat16)),
            ("qr", lambda: torch.linalg.qr(torch.randn(2, 8, 4,
                                                       device="cuda"))),
            ("svd", lambda: torch.linalg.svd(torch.randn(8, 4, device="cuda"),
                                             full_matrices=False))):
        fn()
        torch.cuda.synchronize()
        secs[name] = time.monotonic() - t
        t = time.monotonic()
    return secs


def dp_rank(comm, seed: int, save_dir: str, go, saved, built, restored,
            phases=("17", "18", "19"), ready19=None, go19=None) -> dict:
    """One rank of phase 17: 17a (compressed data parallelism), then 17b
    (ZeRO with ZeRO-2) in the same group; rank 0 records 17a's kernel
    problems, sets ``saved`` once 17b's checkpoint is written, and checks
    the problems after the runs once the parent has set ``restored`` (its
    17c is done, so nothing else runs on the card while they are timed).
    The rank starts while the parent runs the one-process steps, makes its
    first calls then (``dp_warm_up``, on a few elements: their seconds are
    a new process's set-up, not the work's), and trains once ``go`` is
    set. After 17b the rank builds 18a's trainer (``tp_build``) while the
    parent runs 18a alone, and releases ``built`` (the parent times its
    steps once both ranks have); then phase 18 (``tp_rank``, ``ep_rank``)
    in the same group, once the parent's run is done (``restored``) and
    rank 0 has checked phase 17's problems. Then phase 19
    (``shard_rank``): the rank releases ``ready19`` and starts once the
    parent's one-process runs are done (``go19``). ``phases`` names the
    phases to run."""
    import torch.distributed as dist
    from repro_torch.core import qgalore
    from repro_torch.core.quant import QTensor
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import model_zoo
    from repro_torch.train import trainer  # noqa: F401 — import before go
    t_entered = time.monotonic()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    t_warm = time.monotonic()
    warm = dp_warm_up()
    warm_end = time.monotonic()
    go.wait()
    t_start = time.monotonic()
    comm.timed = True
    cfg = dp_config()
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16)
    out = {"rank": comm.rank, "backend": str(dist.get_backend()),
           "warm_up_s": warm, "seconds": {"start": t_start,
                                          "entered": t_entered,
                                          "warm_up": warm_end - t_warm,
                                          "warm_up_end": warm_end}}
    LAUNCHES.clear()
    codes_a = None
    for tag, zero in (("17a", False), ("17b", True)) if "17" in phases \
            else ():
        t_run = time.monotonic()
        gc.collect()
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        tr = dp_trainer(bundle, seed, comm, zero)
        t_init = time.monotonic() - t_run
        rec = ProblemRecorder(record=tag == "17a" and comm.rank == 0)
        # a step's launches, and the problems checked, from the steady
        # steps: step 0 runs the fused update on the distributed layers
        # too, at the first Adam step, whose direction is +-1
        rec.count_from = 1
        with rec:
            run = dp_run(tr, comm, rec, save_dir if zero else "",
                         saved if zero and comm.rank == 0 else None)
        torch.cuda.synchronize()
        run["resident_gib"] = resident
        run["peak_gib"] = max([r["peak_gib"] for r in run["rows"]]
                              + [run["setup_peak_gib"]]
                              + [run["save_peak_gib"] or 0.0])
        run["init_s"] = t_init
        run["opt_bytes"] = tr.opt_state_bytes()
        run["payload_bytes"] = qgalore.dp_payload_bytes(tr.specs)
        run["dist_refresh_units"] = sum(tr.specs[i].nbatch
                                        for i in tr._step.dist_refresh)
        run["zero2_leaves"] = len(tr._step.zero2_dims)
        # on the host: nothing of 17a stays on the card while 17b runs
        codes = [leaf.q.cpu() for _, leaf in qgalore.flatten(tr.state.params)
                 if isinstance(leaf, QTensor)]
        if codes_a is None:
            codes_a = codes
        else:
            same = sum(int((a == b).sum()) for a, b in zip(codes_a, codes))
            run["codes_equal_17a"] = same / sum(c.numel() for c in codes)
        del codes
        if comm.rank or zero:
            run.pop("proj")
        out[tag] = run
        if rec.record:
            out["recorder"] = rec
        del tr
        out["seconds"][tag] = time.monotonic() - t_run
    out["launches"] = dict(LAUNCHES)
    if "18" in phases:
        t = time.monotonic()
        tp_built = tp_build(comm, seed)
        out["seconds"]["18a_build"] = time.monotonic() - t
    built.release()
    restored.wait(DP_WAIT_S)
    if "17" in phases and comm.rank == 0:
        rec = out.pop("recorder")
        t = time.monotonic()
        out["checks"] = rec.check(DP_STEPS - 1, DP_STEPS - 1, seed)
        out["seconds"]["checks"] = time.monotonic() - t
    out["wall_s"] = time.monotonic() - t_start
    if "18" in phases:
        comm.barrier()     # rank 0's phase 17 checks are done
        t = time.monotonic()
        comm.reset_stats()
        out["18a"] = tp_rank(comm, seed, tp_built)
        del tp_built
        out["seconds"]["18a"] = time.monotonic() - t
        comm.reset_stats()
        out["18b"] = ep_rank(comm, seed)
        out["18b"]["rank"] = comm.rank
        out["seconds"]["18b"] = time.monotonic() - t - out["seconds"]["18a"]
    if "19" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        ready19.release()
        go19.wait(DP_WAIT_S)
        t = time.monotonic()
        out["19"] = shard_rank(comm, seed)
        out["seconds"]["19"] = time.monotonic() - t
    return out


def dp_restore(bundle, seed: int, save_dir: str) -> dict:
    """17c: a new one-process trainer restores the checkpoint in
    ``save_dir`` and runs to the end: the step it restored at, the
    restore's seconds, its first step's loss and the whole seconds."""
    gc.collect()
    torch.cuda.empty_cache()
    t = time.monotonic()
    tr = dp_trainer(bundle, seed, checkpoint_dir=save_dir)
    start = tr.maybe_restore()
    restore_s = time.monotonic() - t
    tr.mgr = None
    hist = tr.run(DP_STEPS)
    del tr
    return {"start": start, "restore_s": restore_s, "loss": hist[0]["loss"],
            "s": time.monotonic() - t}


def phase_data_parallel(seed: int, phases=("17", "18", "19")) -> dict:
    """Phase 17: llama-1b at full width and 4 of its 24 layers trained
    data-parallel by two ranks on cuda:0 over gloo (8 x 256 a step, rank
    512, bf16, compressed): 17a against one process on the same batch,
    17b (ZeRO + ZeRO-2) against 17a, 17c a checkpoint of 17b restored
    into one process. Phase 18 in the same two ranks (``tp_rank``,
    ``ep_rank``): 18a tensor-parallel mistral-nemo-12b against this
    process's run of the same steps (``tp_one_process``, after 17c, while
    the ranks finish 17b and build their trainers: its steps start once
    both have; with ``--only 18`` while they start), 18b expert-parallel
    qwen3-moe-30b-a3b. Phase 19 in the same ranks (``shard_rank``), after
    this process's one-process runs (``shard_one_process``), which start
    once both ranks have left phase 18."""
    from repro_torch.distributed.spawn import run_ranks
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import model_zoo
    t_phase = time.monotonic()
    run17 = "17" in phases
    cfg = dp_config()
    if run17:
        log(f"== phase 17: {DP_ARCH} at {DP_LAYERS} of "
            f"{model_zoo.get_config(DP_ARCH).num_layers} layers, full width, "
            f"trained data-parallel by {DP_WORLD} ranks on cuda:0 over gloo "
            "(8 x 256 a step, rank 512, bf16, compress_dp_grads)")
    else:
        log(f"== phase 17's two ranks, for phase(s) {', '.join(phases)} alone")
    log("card:", nvidia_smi_line())
    # the ranks start (processes, imports, the group, their first calls
    # on the card) while this process runs the same steps on the same
    # global batch alone; they wait for ``go`` before they train
    save_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    ctx = mp.get_context("spawn")
    go, saved, restored = ctx.Event(), ctx.Event(), ctx.Event()
    go19 = ctx.Event()
    built, ready19 = ctx.Semaphore(0), ctx.Semaphore(0)
    got: list = []

    def ranks_run():
        try:
            got.append(run_ranks(dp_rank, DP_WORLD, seed, save_dir, go,
                                 saved, built, restored, tuple(phases),
                                 ready19, go19, backend="gloo"))
        except BaseException as e:     # noqa: BLE001 — raised below
            got.append(e)

    def ranks_released(sem):
        """Until both ranks have released ``sem`` (or ended)."""
        n = 0
        while n < DP_WORLD and ranks_thread.is_alive():
            n += sem.acquire(timeout=1.0)

    def ranks_built():
        """Until both ranks have built 18a's trainer (or ended)."""
        ranks_released(built)

    t_spawn = time.monotonic()
    ranks_thread = threading.Thread(target=ranks_run)
    ranks_thread.start()
    one = one18 = one19 = c17 = None
    one_s = 0.0
    try:
        gc.collect()
        torch.cuda.empty_cache()
        if run17:
            bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16)
            t = time.monotonic()
            tr = dp_trainer(bundle, seed)
            LAUNCHES.clear()
            one = dp_run(tr)
            del tr
            one_s = time.monotonic() - t
            gc.collect()
            torch.cuda.empty_cache()
        elif "18" in phases:
            t18 = time.monotonic()
            one18 = tp_one_process(seed)
        go.set()
        t_go = time.monotonic()
        if run17:
            # 17c: 17b's checkpoint, restored into this process as soon as
            # rank 0 has written it, while the ranks finish
            while not saved.wait(1.0) and ranks_thread.is_alive():
                pass
            if saved.is_set():
                c17 = dp_restore(bundle, seed, save_dir)
            del bundle
            if "18" in phases:
                t18 = time.monotonic()
                one18 = tp_one_process(seed, ranks_built)
        restored.set()
        if "19" in phases:
            one19 = shard_one_process(seed, lambda: ranks_released(ready19))
            go19.set()
    finally:
        go.set()
        restored.set()
        go19.set()
        ranks_thread.join()
        shutil.rmtree(save_dir, ignore_errors=True)
    if isinstance(got[0], BaseException):
        raise got[0]
    ranks = got[0]
    ranks_s = time.monotonic() - t_go
    res = {}
    if run17:
        res = dp_result(seed, cfg, ranks, one, one_s, c17, ranks_s, t_go,
                        t_spawn, t_phase)
    if "18" in phases:
        res["parallel"] = parallel_result(ranks, one18, t18)
    if "19" in phases:
        res["sharded"] = shard_result(ranks, one19, one19["t_start"])
    return res


def dp_result(seed, cfg, ranks, one, one_s, c17, ranks_s, t_go, t_spawn,
              t_phase) -> dict:
    """Phase 17's gates and lines from the ranks' runs, the one process's
    and 17c's. ``ranks_s``: from ``go`` until the ranks were done with
    phase 18 too; phase 17's own end on the ranks is their ``wall_s``."""
    from repro_torch.config import ShapeCell
    if c17 is None:
        raise AssertionError("phase 17: 17b's checkpoint was not written")
    ranks_s = max(r["wall_s"] for r in ranks)
    for r in ranks:
        for k in ("start", "entered", "warm_up_end"):
            r["seconds"][k] -= t_go
    gc.collect()
    torch.cuda.empty_cache()
    for r in one["rows"]:
        log(f"  one process step {r['step']}: loss {r['loss']:.6f} "
            f"{r['ms']:.1f} ms launches {r['launches']}")
    problems = []
    res = {"card": card(), "world": DP_WORLD, "layers": DP_LAYERS,
           "backend": ranks[0]["backend"], "ranks_s": ranks_s,
           "one_process": one["rows"]}
    for tag in ("17a", "17b"):
        runs = [r[tag] for r in ranks]
        for k in range(DP_STEPS):
            losses = {r["rows"][k]["loss"] for r in runs}
            if len(losses) != 1:
                problems.append(f"{tag} step {k}: ranks' losses {losses}")
        for r, got in enumerate(runs):
            for row in got["rows"]:
                c = {op: (int(v[0]), int(v[1]), v[2])
                     for op, v in row["collectives"].items()}
                log(f"  {tag} rank {r} step {row['step']}: loss "
                    f"{row['loss']:.6f} {row['ms']:.1f} ms"
                    + (f" (+ save {row['save_s']:.2f} s)"
                       if row["save_s"] else "")
                    + f", subspace {row['subspace_s']:.3f} s, memory "
                    f"{row['resident_gib']:.3f} GiB at its start, peak "
                    f"{row['peak_gib']:.3f} GiB, collectives "
                    + ", ".join(f"{op} {n} calls {b / 2**20:.2f} MiB "
                                f"{s * 1e3:.1f} ms"
                                for op, (n, b, s) in c.items())
                    + f"; launches {row['launches']}")
    a, b = ranks[0]["17a"], ranks[0]["17b"]
    # 17a against the one process
    rel0 = abs(a["rows"][0]["loss"] - one["rows"][0]["loss"]) \
        / abs(one["rows"][0]["loss"])
    if not rel0 <= DP_STEP0_TOL:
        problems.append(f"17a step 0: loss {a['rows'][0]['loss']} vs one "
                        f"process {one['rows'][0]['loss']} (rel {rel0:.2e})")
    for ra, ro in zip(a["rows"], one["rows"]):
        if not np.isfinite(ra["loss"]) or abs(ra["loss"] - ro["loss"]) > \
                DP_LOSS_BAND * max(1.0, abs(ro["loss"])):
            problems.append(f"17a step {ra['step']}: loss {ra['loss']} vs "
                            f"one process {ro['loss']}")
    sims_err = max(float(np.abs(a["sims"][k] - one["sims"][k]).max())
                   for k in one["sims"])
    if set(a["sims"]) != set(one["sims"]) or sims_err > 1e-3:
        problems.append(f"17a sims differ from the one process by "
                        f"{sims_err}")
    p_raw, p_diff, p_cos, p_overlap = dp_proj_agreement(a["proj"],
                                                        one["proj"])
    log(f"  17a P against the one process: raw INT4 codes differing "
        f"{p_raw:.4f}; each column signed as the one process's: entries "
        f"over one quantum apart {p_diff:.4f}, smallest column |cos| "
        f"{p_cos:.4f}; "
        f"smallest subspace overlap {p_overlap:.4f}")
    if p_diff >= 0.02:
        problems.append(f"17a INT4 P (columns signed alike) over one "
                        f"quantum apart in {p_diff:.4f}")
    units = a["dist_refresh_units"]
    for ra, ro in zip(a["rows"], one["rows"]):
        want = dict(ro["launches"])
        if ra["step"] == 0:   # distributed layers update as steady ones
            want["fused_qgalore_update"] = units
        for r in ranks:
            got = r["17a"]["rows"][ra["step"]]["launches"]
            if got != want:
                problems.append(f"17a rank {r['rank']} step {ra['step']} "
                                f"launches {got} != {want}")
    # 17b against 17a
    for rb, ra in zip(b["rows"], a["rows"]):
        if abs(rb["loss"] - ra["loss"]) > DP_LOSS_BAND * abs(ra["loss"]):
            problems.append(f"17b step {rb['step']}: loss {rb['loss']} vs "
                            f"17a {ra['loss']}")
    equal = min(r["17b"]["codes_equal_17a"] for r in ranks)
    if equal < 0.9999:
        problems.append(f"17b W codes equal to 17a's in {equal:.6f}")
    whole, held = b["opt_bytes"]
    if not held < whole or a["opt_bytes"][1] != whole:
        problems.append(f"17b state bytes {b['opt_bytes']} vs 17a "
                        f"{a['opt_bytes']}")
    # ZeRO holds less a rank: its peak, and its steady steps', below 17a's
    steady_peak = lambda run: max(row["peak_gib"] for row in run["rows"][1:])
    for r in ranks:
        if not (r["17b"]["peak_gib"] < r["17a"]["peak_gib"] and
                steady_peak(r["17b"]) < steady_peak(r["17a"])):
            problems.append(
                f"17b rank {r['rank']} peak {r['17b']['peak_gib']:.4f} GiB "
                f"(steady {steady_peak(r['17b']):.4f}) not below 17a's "
                f"{r['17a']['peak_gib']:.4f} ({steady_peak(r['17a']):.4f})")
    # 17c: the checkpoint after 17b's step 2 restored into one process
    want = b["rows"][DP_SAVE_AFTER + 1]["loss"]
    rel_c = abs(c17["loss"] - want) / abs(want)
    if c17["start"] != DP_SAVE_AFTER + 1 or rel_c > RESUME_TOL:
        problems.append(f"17c: restored at {c17['start']}, step-3 loss "
                        f"{c17['loss']} vs 17b's {want} (rel {rel_c:.2e})")
    steady = lambda run: statistics.median(
        max(r[run]["rows"][k]["ms"] for r in ranks)
        for k in range(1, DP_STEPS))
    coll = lambda r, k, op: r["17a"]["rows"][k]["collectives"].get(
        op, [0, 0, 0.0])
    res.update({
        "losses_17a": [r["loss"] for r in a["rows"]],
        "losses_one_process": [r["loss"] for r in one["rows"]],
        "losses_17b": [r["loss"] for r in b["rows"]],
        "step0_rel_diff": rel0, "sims_max_abs_diff": sims_err,
        "int4_codes_differing_raw": p_raw,
        "int4_codes_differing_signed": p_diff, "p_column_cos_min": p_cos,
        "p_subspace_overlap_min": p_overlap,
        "codes_equal_17b_17a": equal,
        "steady_step_ms_17a": steady("17a"),
        "steady_step_ms_17b": steady("17b"),
        "steady_step_ms_one_process": statistics.median(
            r["ms"] for r in one["rows"][1:]),
        "refresh_step_s": [r["17a"]["rows"][0]["ms"] / 1e3 for r in ranks],
        "refresh_subspace_s": [r["17a"]["rows"][0]["subspace_s"]
                               for r in ranks],
        "one_process_refresh_s": one["rows"][0]["ms"] / 1e3,
        "steady_collectives": {op: coll(ranks[0], 1, op) for op in
                               ("all_reduce", "reduce_scatter",
                                "all_gather")},
        "zero2_steady_collectives": b["rows"][1]["collectives"],
        "payload_bytes": a["payload_bytes"],
        "opt_bytes_17a": a["opt_bytes"], "opt_bytes_17b": b["opt_bytes"],
        "peak_gib_17a": [r["17a"]["peak_gib"] for r in ranks],
        "peak_gib_17b": [r["17b"]["peak_gib"] for r in ranks],
        "memory_gib": {tag: {k: [r[tag][k] for r in ranks] for k in (
            "resident_gib", "setup_peak_gib", "save_peak_gib")}
            for tag in ("17a", "17b")},
        "init_s": {tag: [r[tag]["init_s"] for r in ranks]
                   for tag in ("17a", "17b")},
        "zero2_leaves": b["zero2_leaves"], "dist_refresh_units": units,
        "restore_s": c17["restore_s"], "restored_step3_rel_diff": rel_c,
        "warm_up_s": [r["warm_up_s"] for r in ranks],
        "seconds": {"one_process": one_s, "ranks": ranks_s,
                    "restore_and_step": c17["s"], **{
                        f"rank0_{k}": v
                        for k, v in ranks[0]["seconds"].items()}},
        "launches": {n: sum(r["launches"].get(n, 0) for r in ranks)
                     for n in TRAIN_KERNELS},
        "train_kernels": ranks[0]["checks"]})
    ar = res["steady_collectives"]["all_reduce"]
    log(f"  17a: step-0 loss {a['rows'][0]['loss']:.6f} (mean of ranks) vs "
        f"{one['rows'][0]['loss']:.6f} one process (rel {rel0:.2e}); sims "
        f"max diff {sims_err:.2e}; INT4 P over one quantum apart "
        f"{p_diff:.4f} (columns signed alike); "
        f"{units} layers refreshed distributed")
    log(f"  17a steady step {res['steady_step_ms_17a']:.1f} ms a rank vs "
        f"{res['steady_step_ms_one_process']:.1f} ms one process; all-reduce "
        f"{int(ar[0])} calls {ar[1] / 2**20:.2f} MiB ({ar[2] * 1e3:.1f} ms) a "
        f"steady step beside dp_payload_bytes {a['payload_bytes'] / 2**20:.2f}"
        f" MiB; refresh step {res['refresh_step_s']} s, subspace "
        f"{res['refresh_subspace_s']} s a rank (one process "
        f"{res['one_process_refresh_s']:.2f} s)")
    log(f"  17b: W codes equal to 17a's {equal:.6f}; optimizer state a rank "
        f"{b['opt_bytes'][1] / 2**20:.1f} MiB vs "
        f"{a['opt_bytes'][1] / 2**20:.1f}"
        f" MiB ({a['opt_bytes'][1] / b['opt_bytes'][1]:.2f}x); peak "
        f"{res['peak_gib_17b']} GiB a rank (17a {res['peak_gib_17a']}); "
        f"steady step {res['steady_step_ms_17b']:.1f} ms")
    for tag in ("17a", "17b"):
        m = res["memory_gib"][tag]
        log(f"  {tag} memory a rank: {m['resident_gib']} GiB allocated "
            f"before the trainer, set-up peak {m['setup_peak_gib']} GiB, "
            f"save peak {m['save_peak_gib']} GiB; trainer built in "
            f"{res['init_s'][tag]} s")
    log(f"  17c: restored at step {c17['start']} in "
        f"{c17['restore_s']:.2f} s (beside the ranks' last step); step-3 "
        f"loss {c17['loss']:.6f} vs 17b's {want:.6f} (rel {rel_c:.2e})")
    res["roofline"] = step_roofline(
        "17a", cfg, ShapeCell("train", 256, 8, "train"),
        res["steady_step_ms_17a"], rank=512)
    res["wall_s"] = t_go - t_phase + ranks_s
    sec = res["seconds"]
    warm = ", ".join(f"{k} {v:.2f}" for k, v in ranks[0]["warm_up_s"].items())
    log(f"  phase 17: {res['wall_s']:.1f} s: the one process {one_s:.1f} s, "
        f"the two ranks {ranks_s:.1f} s after it (spawned "
        f"{t_go - t_spawn:.1f} s before; rank 0 started and imported "
        f"{sec['rank0_entered'] + t_go - t_spawn:.1f} s after the spawn; its "
        f"first calls {sec['rank0_warm_up']:.1f} s ({warm}), done "
        f"{abs(sec['rank0_warm_up_end']):.1f} s "
        f"{'after' if sec['rank0_warm_up_end'] > 0 else 'before'} it; 17a "
        f"{sec['rank0_17a']:.1f} s, 17b {sec['rank0_17b']:.1f} s, "
        f"kernel checks {sec['rank0_checks']:.1f} s), 17c {c17['s']:.1f} s "
        "of it in this process")
    if problems:
        raise AssertionError("phase 17: " + "; ".join(problems))
    return res


# ---------------------------------------------------------------------------
# Phase 18: tensor and expert parallelism, in phase 17's two ranks
# ---------------------------------------------------------------------------

TP_ARCH = "mistral-nemo-12b"
TP_LAYERS = 2          # of 40: the layer stack splits over the 2 ranks, so
                       # the combined-front refresh runs
TP_RANK = 1024         # the llama-7b row of benchmarks/table2_memory.py
TP_STEPS = 4           # step 0 refreshes (randomized), 1-3 steady
TP_LOSS_BAND = 2e-3    # the reference's trajectory band
                       # (tests/test_golden.py:41-42)
# 12c's layers and rank; 2 x 256 a rank: T·k = 4096, drop-free. 2 steps
# (a refresh and a steady one), the one cut phase 18 allows: the script
# took 1238.7 s on a slow host with 3 (PERF.md §6)
EP_LAYERS, EP_STEPS, EP_ROWS = 2, 2, 2


def tp_config():
    from repro_torch.config import replace
    from repro_torch.models import model_zoo
    return replace(model_zoo.get_config(TP_ARCH), num_layers=TP_LAYERS)


def tp_trainer(bundle, seed: int, group=None):
    """18a's trainer: 8 x 256 a step, bf16, rank 1024, the randomized
    subspace, compressed (the distributed refresh's combined front)."""
    from repro_torch.config import QGaLoreConfig, TrainConfig
    from repro_torch.core.optimizers import preset
    from repro_torch.train.trainer import Trainer
    qcfg = preset("qgalore", QGaLoreConfig(
        rank=TP_RANK, subspace_method="randomized", compress_dp_grads=True))
    tcfg = TrainConfig(seed=seed, global_batch=8, seq_len=256,
                       steps=TP_STEPS, learning_rate=1e-3, warmup_steps=2,
                       grad_clip=1.0, log_every=0)
    return Trainer(bundle, tcfg, qcfg, group=group)


def int8_bytes(params) -> int:
    """The bytes of every INT8 weight's codes and scales in a tree."""
    from repro_torch.core import qgalore
    from repro_torch.core.quant import QTensor
    return sum(t.numel() * t.element_size()
               for _, x in qgalore.flatten(params) if isinstance(x, QTensor)
               for t in (x.q, x.scale))


def tp_one_process(seed: int, before_steps=None) -> dict:
    """18a's one process: the same steps on the same global batch; its
    trainer is built, then ``before_steps()`` (waiting for the ranks'
    builds, which share the card) runs before the timed steps."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import model_zoo
    gc.collect()
    torch.cuda.empty_cache()
    t = time.monotonic()
    bundle = model_zoo.build(tp_config(), device="cuda", dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    tr = tp_trainer(bundle, seed)
    if before_steps is not None:
        t_wait = time.monotonic()
        before_steps()
        t_wait = time.monotonic() - t_wait
    LAUNCHES.clear()
    one = dp_run(tr, steps=TP_STEPS)
    del tr, bundle
    gc.collect()
    torch.cuda.empty_cache()
    one["s"] = time.monotonic() - t
    one["wait_s"] = t_wait if before_steps is not None else 0.0
    return one


def tp_build(comm, seed: int) -> dict:
    """18a's trainer on this rank: mistral-nemo-12b at full width and 2
    layers on the (1, 2) mesh, its model group the two ranks; each leaf
    is cut to the rank's slice as it is drawn."""
    from repro_torch.distributed.comm import mesh_comms
    from repro_torch.models import model_zoo
    t0 = time.monotonic()
    groups = mesh_comms(comm, (1, 2))
    bundle = model_zoo.build(tp_config(), device="cuda",
                             dtype=torch.bfloat16, tp_group=groups.model)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = tp_trainer(bundle, seed, groups)
    torch.cuda.synchronize()
    out = {"groups": groups, "trainer": tr, "init_s": time.monotonic() - t0,
           "init_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    # the draw's transients back to the card: the parent's one-process
    # run of 18a (a 38.9 GiB peak) runs beside the built trainers
    gc.collect()
    torch.cuda.empty_cache()
    out["resident_gib"] = torch.cuda.memory_allocated() / 2 ** 30
    return out


def tp_rank(comm, seed: int, built: dict) -> dict:
    """18a on this rank, on the trainer ``tp_build`` made; rank 0 records
    the slice problems of the last steady step (the host copies of a
    problem's first inputs would slow the step they are taken in, and the
    other rank waits for it: the earlier steady steps stay clean for the
    median) and holds them against their plain versions after the
    run."""
    from repro_torch.core import qgalore
    from repro_torch.kernels import LAUNCHES
    from repro_torch.train import step as step_lib
    t0 = time.monotonic()
    groups, tr = built.pop("groups"), built.pop("trainer")
    bundle, cfg = tr.bundle, tp_config()
    whole = step_lib.abstract_params(bundle, tr.rules, tr.param_dtype)
    flat_w = dict(qgalore.flatten(whole))
    want_bytes = sum(
        int8_bytes({"w": flat_w[k]}) // (s.tp if s.shard_dim is not None
                                         else 1)
        for (k, _), s in zip(qgalore.flatten(whole), tr.specs))
    rec = ProblemRecorder(record=comm.rank == 0)
    rec.count_from = TP_STEPS - 1
    LAUNCHES.clear()
    with rec:
        run = dp_run(tr, groups.model, rec, steps=TP_STEPS)
    run.pop("proj")
    run.update({
        "init_s": built["init_s"], "init_peak_gib": built["init_peak_gib"],
        "built_resident_gib": built["resident_gib"],
        "int8_bytes": int8_bytes(tr.state.params),
        "int8_bytes_want": want_bytes,
        "int8_bytes_whole": int8_bytes(whole),
        "payload_bytes": qgalore.tp_payload_bytes(cfg, tr.specs, 8, 256),
        "sharded": sum(s.shard_dim is not None for s in tr.specs),
        "units": sum(s.nbatch for s in tr.local_specs if s.galore),
        "dist_refresh": len(tr._step.dist_refresh),
        "launches": dict(LAUNCHES)})
    del tr, bundle
    gc.collect()
    torch.cuda.empty_cache()
    run["run_s"] = time.monotonic() - t0
    if comm.rank == 0:
        t = time.monotonic()
        # the plain versions at these slices take up to ~0.1 s a call: the
        # median of 3 (the kernels and cuBLAS still of 20)
        run["checks"] = rec.check(1, 1, seed, plain_reps=3)
        run["checks_s"] = time.monotonic() - t
    comm.barrier()        # nothing else on the card while rank 0 times
    run["wall_s"] = time.monotonic() - t0
    return run


def ep_layer_check(tr, comm, cfg) -> dict:
    """18b at step 0's inputs: the input of layer 0's MoE on this rank's
    rows, through ``moe_apply_ep`` (the rank's 64 experts, the exchange)
    and through ``moe_apply`` on the whole layer (every expert, gathered),
    in bf16 and in f32: both drop-free, so they compute one function."""
    from repro_torch.core import qgalore
    from repro_torch.core.quant import QTensor
    from repro_torch.models import attention, moe
    from repro_torch.models.base import layer_params
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.transformer import Q_CHUNK
    batch = tr.batches(0)
    lo, hi = tr.rows
    batch = {k: v[lo:hi] for k, v in batch.items()}
    bundle = tr.bundle
    params = tr.state.params
    with torch.no_grad():
        carry, ctx = bundle.embed(params, batch)
        lp = layer_params(params[bundle.seg_key(0)], 0)
        h = carry["h"]
        x = rmsnorm(h, lp["attn_norm"], cfg.rmsnorm_eps)
        h = h + attention.gqa_apply(lp["attn"], x, cfg,
                                    positions=ctx["positions"],
                                    q_chunk=Q_CHUNK, dtype=torch.bfloat16)
        x = rmsnorm(h, lp["ffn_norm"], cfg.rmsnorm_eps)
        local = lp["moe"]
        whole = dict(local)
        for k, v in local.items():
            if k.startswith("experts_"):
                got = comm.all_gather_many([(v.q, 0), (v.scale, 0)])
                whole[k] = QTensor(got[0], got[1], None, v.bits, v.block,
                                   v.orig_last, v.dtype)
        out = {}
        E_loc = cfg.moe.num_experts // comm.world
        T = x.shape[0] * x.shape[1]
        for dt in (torch.bfloat16, torch.float32):
            xd = x.to(dt)
            got, _ = moe.moe_apply_ep(local, xd, cfg, comm, dtype=dt)
            want, _ = moe.moe_apply(whole, xd, cfg, dtype=dt)
            peak = max(want.abs().max().item(), 1e-30)
            rel = (got - want).abs().max().item() / peak
            tol = 1e-5 if dt == torch.float32 else max(
                batched_tol(E_loc, comm.world * T, K, N, dt)
                for K, N in ((cfg.d_model, cfg.moe.expert_ff),
                             (cfg.moe.expert_ff, cfg.d_model)))
            out[str(dt).replace("torch.", "")] = {
                "rel_err": rel, "tol": tol, "ok": rel <= tol}
            del got, want
        del whole, x, h, carry
    log(f"  18b rank {comm.rank}: moe_apply_ep against moe_apply on the "
        f"rank's {T} tokens at step 0's inputs: "
        + ", ".join(f"{k} rel err {v['rel_err']:.2e} (bar {v['tol']:.0e})"
                    for k, v in out.items()))
    return out


def ep_batched_rows(probs: dict, seed: int, mult: dict) -> list:
    """The batched pair at 18b's expert problems (E 64 a rank, M = 2·T),
    each on fresh seeded inputs against its plain version and timed (cold
    L2, median of 20) beside one ``torch.bmm`` on the bf16 stack
    dequantized beforehand, and the bound; ``mult``: the launches of each
    ``(wrapper, K, N)`` counted in the run's steady step."""
    from repro_torch.analysis.roofline import kernel_bound
    from repro_torch.core import quant
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.kernels import profile as kprof
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 24)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = []
    for (E, M, K, N, dt) in sorted(probs, key=lambda k: k[:4]):
        if dt != torch.bfloat16:
            continue
        q, sc = random_stack(E, K, N, gen)
        w_lib = torch.cat([quant.dequantize(quant.QTensor(
            q[e: e + EXPERT_CHUNK], sc[e: e + EXPERT_CHUNK], None, 8, 256, N,
            "float32"), torch.bfloat16) for e in range(0, E, EXPERT_CHUNK)])
        for name, transposed in (("int8_matmul_batched", False),
                                 ("int8_matmul_t_batched", True)):
            rows_in = torch.randn((E, M, N if transposed else K),
                                  generator=gen, device=dev).to(dt)
            fn = ti8.int8_matmul_t_batched if transposed \
                else ti8.int8_matmul_batched
            got = fn(rows_in, q, sc)
            want = plain_batched(rows_in, q, sc, transposed)
            abs_err = (got - want).abs().max().item()
            rel = abs_err / max(want.abs().max().item(), 1e-30)
            tol = F32_X_TOL if transposed else batched_tol(E, M, K, N, dt)
            lib = (lambda: torch.bmm(rows_in, w_lib.transpose(1, 2))) \
                if transposed else (lambda: torch.bmm(rows_in, w_lib))
            row = {"kernel": name, "E": E, "M": M, "K": K, "N": N,
                   "x": "bfloat16", "max_abs_err": abs_err,
                   "rel_err": rel, "tol": tol,
                   "ok": rel <= tol,
                   "ms": time_ms(lambda: fn(rows_in, q, sc), flush),
                   "plain_ms": time_ms(lambda: plain_batched(
                       rows_in, q, sc, transposed), flush, reps=3),
                   "library_ms": time_ms(lib, flush),
                   "launches_per_step": mult.get((name, K, N), 0)}
            row["bound_ms"], row["bound_by"] = kernel_bound(
                *kprof.batched_cost(E, M, K, N, 2, transposed, 256))
            rows.append(row)
            log(f"  18b {name} E={E} M={M} K={K} N={N} bf16 "
                f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.3f} "
                f"library_ms={row['library_ms']:.4f} bound_ms="
                f"{row['bound_ms']:.4f} ({row['bound_by']}) rel_err={rel:.2e}"
                f" {'ok' if row['ok'] else 'FAIL'}; "
                f"{row['launches_per_step']} launches a step")
            del rows_in, got, want
        del q, sc, w_lib
    torch.cuda.empty_cache()
    return rows


def ep_rank(comm, seed: int) -> dict:
    """18b on this rank: qwen3-moe-30b-a3b at full width and 2 layers, its
    experts split over the two ranks (64 a rank), 2 x 256 tokens a rank,
    rank 128, randomized, ``EP_STEPS`` steps; rank 0 then times the
    batched pair at the run's expert problems."""
    from repro_torch.config import (QGaLoreConfig, TrainConfig, replace)
    from repro_torch.core import qgalore
    from repro_torch.core.optimizers import preset
    from repro_torch.distributed import tp as tp_lib
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import model_zoo
    from repro_torch.train.trainer import Trainer
    t0 = time.monotonic()
    cfg = replace(model_zoo.get_config(MOE_ARCH), num_layers=EP_LAYERS)
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16,
                             ep_group=comm)
    qcfg = preset("qgalore", QGaLoreConfig(
        rank=MOE_RANK, subspace_method="randomized", compress_dp_grads=True))
    tcfg = TrainConfig(seed=seed, global_batch=EP_ROWS * comm.world,
                       seq_len=256, steps=EP_STEPS, learning_rate=1e-3,
                       warmup_steps=1, grad_clip=1.0, log_every=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(bundle, tcfg, qcfg, group=comm)
    init_s = time.monotonic() - t0
    layer = ep_layer_check(tr, comm, cfg)
    comm.reset_stats()
    LAUNCHES.clear()
    brec = BatchedRecorder()
    brec.count_from = EP_STEPS - 1          # the steady step alone
    with brec:
        run = dp_run(tr, comm, brec, steps=EP_STEPS)
    run.pop("proj")
    T = EP_ROWS * 256
    C = T                                   # drop-free: every token kept
    experts = {i for i, s in enumerate(tr.local_specs)
               if tp_lib.is_expert(s.path)}
    run.update({
        "init_s": init_s, "layer_check": layer,
        "units": sum(s.nbatch for s in tr.local_specs if s.galore),
        "expert_units": sum(tr.local_specs[i].nbatch for i in experts),
        "experts_a_rank": tr.local_specs[min(experts)].shape[-3],
        "payload_bytes": qgalore.dp_payload_bytes(
            [s for i, s in enumerate(tr.local_specs) if i not in experts]),
        "a2a_bytes_want": 6 * EP_LAYERS * cfg.moe.num_experts * C
        * cfg.d_model * 2,
        "launches": dict(LAUNCHES),
        # the batched calls of the steady step by (wrapper, K, N), and
        # what a layer implies: the forward and the recompute run wi, wg
        # (d -> ff) and wd (ff -> d), the backward's dL/dx each once
        "batched_launches": dict(brec.counts),
        "batched_want": {
            ("int8_matmul_batched", cfg.d_model, cfg.moe.expert_ff):
            4 * EP_LAYERS,
            ("int8_matmul_batched", cfg.moe.expert_ff, cfg.d_model):
            2 * EP_LAYERS,
            ("int8_matmul_t_batched", cfg.d_model, cfg.moe.expert_ff):
            2 * EP_LAYERS,
            ("int8_matmul_t_batched", cfg.moe.expert_ff, cfg.d_model):
            EP_LAYERS}})
    steady = run["rows"][-1]["launches"]
    del tr, bundle
    gc.collect()
    torch.cuda.empty_cache()
    if comm.rank == 0:
        t = time.monotonic()
        E = cfg.moe.num_experts // comm.world
        run["batched"] = ep_batched_rows(
            {k for k in brec.i if k[0] == E}, seed, run["batched_launches"])
        run["checks_s"] = time.monotonic() - t
    run["steady_launches"] = steady
    comm.barrier()
    run["wall_s"] = time.monotonic() - t0
    return run


def parallel_result(ranks: list, one: dict, t18: float) -> dict:
    """Phase 18's gates and lines; its seconds from the start of this
    process's one-process run of 18a."""
    from repro_torch.config import replace
    from repro_torch.models import model_zoo
    log(f"== phase 18: {TP_ARCH} at {TP_LAYERS} of "
        f"{model_zoo.get_config(TP_ARCH).num_layers} layers tensor-parallel "
        f"on the (1, 2) mesh (18a), {MOE_ARCH} at {EP_LAYERS} layers "
        "expert-parallel on the (2, 1) mesh (18b), in phase 17's ranks on "
        "cuda:0 over gloo")
    log("card:", nvidia_smi_line())
    for r in one["rows"]:
        log(f"  18a one process step {r['step']}: loss {r['loss']:.6f} "
            f"{r['ms']:.1f} ms, peak {r['peak_gib']:.3f} GiB, launches "
            f"{r['launches']}")
    for r in ranks:
        for tag in ("18a", "18b"):
            for row in r[tag]["rows"]:
                c = {op: (int(v[0]), int(v[1]), v[2])
                     for op, v in row["collectives"].items()}
                log(f"  {tag} rank {r['rank']} step {row['step']}: loss "
                    f"{row['loss']:.6f} {row['ms']:.1f} ms, subspace "
                    f"{row['subspace_s'] or 0.0:.3f} s, peak "
                    f"{row['peak_gib']:.3f} GiB, collectives "
                    + ", ".join(f"{op} {n} calls {b / 2**20:.2f} MiB "
                                f"{s * 1e3:.1f} ms"
                                for op, (n, b, s) in c.items())
                    + f"; launches {row['launches']}")
    tp, p_tp = evaluate_tp(ranks, one, tp_config())
    ep, p_ep = evaluate_ep(ranks, replace(model_zoo.get_config(MOE_ARCH),
                                          num_layers=EP_LAYERS))
    res = {"card": card(), "tp": tp, "ep": ep,
           "one_process_s": one["s"],
           "ranks_s": {tag: [r["seconds"][tag] for r in ranks]
                       for tag in ("18a", "18b")},
           "wall_s": time.monotonic() - t18}
    log(f"  phase 18: {res['wall_s']:.1f} s: the one process's 18a "
        f"{one['s']:.1f} s (of it {one['wait_s']:.1f} s waiting for the "
        f"ranks' 18a trainers, built beside it in {tp['init_s']} s, peak "
        f"{tp['init_peak_gib']} GiB, then {tp['built_resident_gib']} GiB "
        "held), then the ranks' 18a "
        f"{res['ranks_s']['18a']} s (rank 0's checks {tp['checks_s']:.1f} s)"
        f" and 18b {res['ranks_s']['18b']} s (trainer {ep['init_s']} s, rank "
        f"0's batched rows {ep['checks_s']:.1f} s)")
    if p_tp or p_ep:
        raise AssertionError("phase 18: " + "; ".join(p_tp + p_ep))
    return res


def evaluate_tp(ranks: list, one: dict, cfg) -> tuple:
    """18a's gates and lines from the ranks' runs and the one process's."""
    problems = []
    runs = [r["18a"] for r in ranks]
    a, o = runs[0], one
    for k in range(TP_STEPS):
        losses = {r["rows"][k]["loss"] for r in runs}
        if len(losses) != 1:
            problems.append(f"18a step {k}: ranks' losses {losses}")
    for ra, ro in zip(a["rows"], o["rows"]):
        rel = abs(ra["loss"] - ro["loss"]) / abs(ro["loss"])
        ra["rel_to_one"] = rel
        if not np.isfinite(ra["loss"]) or rel > TP_LOSS_BAND:
            problems.append(f"18a step {ra['step']}: loss {ra['loss']} vs "
                            f"one process {ro['loss']} (rel {rel:.2e})")
    if any(set(r["sims"]) != set(a["sims"]) or any(
            not np.array_equal(r["sims"][k], a["sims"][k])
            for k in a["sims"]) for r in runs[1:]):
        problems.append("18a: the ranks' similarities differ")
    if set(a["sims"]) != set(o["sims"]):
        problems.append("18a: refreshed leaves differ from the one process's")
    sims_err = max(float(np.abs(a["sims"][k] - o["sims"][k]).max())
                   for k in o["sims"])
    for r in runs:
        for row, ro in zip(r["rows"], o["rows"]):
            want = {n: ro["launches"][n] for n in ("int8_matmul",
                                                   "int8_matmul_t")}
            want["fused_qgalore_update"] = r["units"]
            got = {n: row["launches"][n] for n in want}
            plain = {n: c for n, c in row["launches"].items()
                     if n not in TRAIN_KERNELS and c}
            if got != want or plain:
                problems.append(f"18a step {row['step']} launches {got} != "
                                f"{want} (plain {plain})")
        if r["int8_bytes"] != r["int8_bytes_want"]:
            problems.append(f"18a INT8 bytes a rank {r['int8_bytes']} != "
                            f"{r['int8_bytes_want']}")
        for row in r["rows"][1:]:
            moved = int(sum(v[1] for v in row["collectives"].values()))
            if moved != r["payload_bytes"]:
                problems.append(f"18a step {row['step']}: the model group "
                                f"moved {moved} B, tp_payload_bytes "
                                f"{r['payload_bytes']}")
        for k, label in ((0, "refresh"), (1, "steady")):
            if not r["rows"][k]["peak_gib"] < o["rows"][k]["peak_gib"]:
                problems.append(
                    f"18a {label} step peak {r['rows'][k]['peak_gib']:.3f} "
                    f"GiB not below the one process's "
                    f"{o['rows'][k]['peak_gib']:.3f}")
    steady = statistics.median(max(r["rows"][k]["ms"] for r in runs)
                               for k in range(1, TP_STEPS))
    one_steady = statistics.median(r["ms"] for r in o["rows"][1:])
    coll = a["rows"][1]["collectives"]
    res = {"losses": [r["loss"] for r in a["rows"]],
           "losses_one_process": [r["loss"] for r in o["rows"]],
           "rel_to_one": [r["rel_to_one"] for r in a["rows"]],
           "sims_max_abs_diff_one": sims_err,
           "steady_step_ms": steady, "steady_step_ms_one_process": one_steady,
           "refresh_step_s": [r["rows"][0]["ms"] / 1e3 for r in runs],
           "refresh_step_s_one_process": o["rows"][0]["ms"] / 1e3,
           "steady_collectives": coll, "payload_bytes": a["payload_bytes"],
           "int8_bytes": [r["int8_bytes"] for r in runs],
           "int8_bytes_whole": a["int8_bytes_whole"],
           "peak_gib": {k: [r["rows"][i]["peak_gib"] for r in runs]
                        for k, i in (("refresh", 0), ("steady", 1))},
           "peak_gib_one_process": {"refresh": o["rows"][0]["peak_gib"],
                                    "steady": o["rows"][1]["peak_gib"]},
           "launches": {n: sum(r["launches"].get(n, 0) for r in runs)
                        for n in TRAIN_KERNELS},
           "launches_per_step": a["rows"][1]["launches"],
           "init_s": [r["init_s"] for r in runs],
           "init_peak_gib": [r["init_peak_gib"] for r in runs],
           "built_resident_gib": [r["built_resident_gib"] for r in runs],
           "wall_s": [r["wall_s"] for r in runs],
           "checks_s": a.get("checks_s"), "train_kernels": a["checks"]}
    log(f"  18a: losses {[round(x, 6) for x in res['losses']]} against the "
        f"one process's {[round(x, 6) for x in res['losses_one_process']]} "
        f"(rel {[f'{x:.2e}' for x in res['rel_to_one']]}, band "
        f"{TP_LOSS_BAND:.0e}); sims equal across ranks, max "
        f"{sims_err:.2e} from the one process's")
    log(f"  18a steady step {steady:.1f} ms a rank vs {one_steady:.1f} ms one "
        f"process; refresh step {res['refresh_step_s']} s a rank (one "
        f"process {res['refresh_step_s_one_process']:.2f} s); the model "
        "group a steady step: " + ", ".join(
            f"{op} {int(n)} calls {b / 2**20:.2f} MiB {t * 1e3:.1f} ms"
            for op, (n, b, t) in coll.items())
        + f" (tp_payload_bytes {a['payload_bytes'] / 2**20:.2f} MiB); INT8 "
        f"weights {res['int8_bytes']} B a rank of {a['int8_bytes_whole']} "
        f"whole; peaks {res['peak_gib']} GiB a rank vs "
        f"{res['peak_gib_one_process']} one process; launches a steady step "
        f"{ {n: res['launches_per_step'][n] for n in TRAIN_KERNELS} }")
    from repro_torch.config import ShapeCell
    res["roofline"] = step_roofline("18a", cfg, ShapeCell("train", 256, 8,
                                                          "train"),
                                    steady, rank=TP_RANK)
    return res, problems


def evaluate_ep(ranks: list, cfg) -> tuple:
    """18b's gates and lines."""
    problems = []
    runs = [r["18b"] for r in ranks]
    for r in runs:
        if r["batched_launches"] != r["batched_want"]:
            problems.append(f"18b rank {r['rank']}: batched launches a "
                            f"steady step {r['batched_launches']}, want "
                            f"{r['batched_want']}")
        for dt, c in r["layer_check"].items():
            if not c["ok"]:
                problems.append(f"18b rank {r['rank']} {dt}: moe_apply_ep "
                                f"vs moe_apply rel {c['rel_err']:.2e}")
        for row in r["rows"]:
            if not np.isfinite(row["loss"]):
                problems.append(f"18b step {row['step']}: loss {row['loss']}")
        for row in r["rows"][1:]:
            f = row["launches"]["fused_qgalore_update"]
            if f != r["units"]:
                problems.append(f"18b step {row['step']}: "
                                f"{f} fused updates, {r['units']} owned units")
            c = row["collectives"]
            a2a = int(c.get("all_to_all", [0, 0])[1])
            ar = int(c.get("all_reduce", [0, 0])[1])
            metric_bytes = ar - r["payload_bytes"]
            if a2a != r["a2a_bytes_want"] or not 0 < metric_bytes <= 64:
                problems.append(
                    f"18b step {row['step']}: all-to-all {a2a} B (want "
                    f"{r['a2a_bytes_want']}), all-reduce {ar} B against "
                    f"dp_payload_bytes {r['payload_bytes']} of the non-expert "
                    "leaves (the rest: the loss, metrics and clip norm)")
    a = runs[0]
    for bad in [b for b in a["batched"] if not b["ok"]]:
        problems.append(f"18b {bad['kernel']} {bad}")
    steady = statistics.median(max(r["rows"][k]["ms"] for r in runs)
                               for k in range(1, EP_STEPS))
    coll = a["rows"][1]["collectives"]
    res = {"losses": [[row["loss"] for row in r["rows"]] for r in runs],
           "steady_step_ms": steady,
           "refresh_step_s": [r["rows"][0]["ms"] / 1e3 for r in runs],
           "experts_a_rank": a["experts_a_rank"], "units": a["units"],
           "expert_units": a["expert_units"],
           "layer_check": [r["layer_check"] for r in runs],
           "steady_collectives": coll, "payload_bytes": a["payload_bytes"],
           "a2a_bytes_want": a["a2a_bytes_want"],
           "peak_gib": [max(row["peak_gib"] for row in r["rows"])
                        for r in runs],
           "launches": {n: sum(r["launches"].get(n, 0) for r in runs)
                        for n in TRAIN_KERNELS + ("int8_matmul_batched",
                                                  "int8_matmul_t_batched")},
           "launches_per_step": a["steady_launches"],
           "batched_launches_per_step": [
               {f"{n} ({K}, {N})": c for (n, K, N), c in
                sorted(r["batched_launches"].items())} for r in runs],
           "init_s": [r["init_s"] for r in runs],
           "wall_s": [r["wall_s"] for r in runs],
           "checks_s": a.get("checks_s"), "batched": a["batched"]}
    log(f"  18b: {a['experts_a_rank']} experts a rank; losses "
        f"{res['losses']}; steady step {steady:.1f} ms a rank, refresh step "
        f"{res['refresh_step_s']} s; the data group a steady step: "
        + ", ".join(f"{op} {int(n)} calls {b / 2**20:.2f} MiB "
                    f"{t * 1e3:.1f} ms" for op, (n, b, t) in coll.items())
        + f" (all-to-all want {a['a2a_bytes_want'] / 2**20:.2f} MiB; "
        f"dp_payload_bytes of the non-expert leaves "
        f"{a['payload_bytes'] / 2**20:.2f} MiB); fused updates a steady step "
        f"{a['steady_launches']['fused_qgalore_update']} = {a['units']} "
        f"owned units ({a['expert_units']} (layer, expert) problems); "
        f"batched launches a steady step {res['batched_launches_per_step']} "
        f"(want {sorted(a['batched_want'].values())}); peak "
        f"{res['peak_gib']} GiB a rank")
    from repro_torch.config import ShapeCell
    res["roofline"] = step_roofline(
        "18b", cfg, ShapeCell("train", 256, EP_ROWS * len(ranks), "train"),
        steady, rank=MOE_RANK)
    return res, problems


# ---------------------------------------------------------------------------
# Phase 19: sharded serving, in phase 17's two ranks
# ---------------------------------------------------------------------------

SHARD_ARCH = "llama-1b"
SHARD_LAYERS = 24      # full depth; the one cut allowed is 8 (PERF.md §4)
SHARD_F32_LAYERS = 2   # the f32 token gates
SHARD_TP_LAYERS = SERVE_DEPTH[TP_ARCH]   # 11a's cut: 8 of 40


def shard_config(arch: str, layers: int):
    from repro_torch.config import replace
    from repro_torch.models import model_zoo
    return replace(model_zoo.get_config(arch), num_layers=layers)


def shard_blocks() -> int:
    """The paged pool's blocks for 11a's slots and window (the default)."""
    return DENSE_SLOTS * -(-DENSE_WINDOW // PAGED_BLOCK) + 1


def shard_model(cfg, seed: int, dtype, tp_group=None):
    """``cfg``'s bundle and INT8 weights drawn on the card from ``seed``
    one layer of a group at a time, as 11a draws them: the same codes in
    every process. With ``tp_group`` the bundle computes on the rank's
    slices, which are cut from the whole draw; the whole tree's and the
    rank's INT8 bytes are returned beside them, and those of the leaves
    the plan keeps whole."""
    from repro_torch.config import QGaLoreConfig
    from repro_torch.core import qgalore
    from repro_torch.distributed import tp
    from repro_torch.models import model_zoo
    from repro_torch.serve.params import quantize_leaf
    whole = model_zoo.build(cfg, device="cuda", dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    params = whole.init_params(gen, leaf_fn=lambda _, t: quantize_leaf(t),
                               by_layer=True)
    info = {"int8_bytes_whole": int8_bytes(params)}
    if tp_group is None:
        return whole, params, info
    # what the plan leaves whole on every rank: the stacked norm scales,
    # INT8 in a serving tree (quantize_leaf); every matrix splits
    specs = tp.plan_specs(qgalore.leaf_specs(params, QGaLoreConfig()),
                          tp_group.world, cfg)
    info["int8_bytes_replicated"] = sum(
        int8_bytes({"w": x}) for (_, x), sp in zip(
            qgalore.flatten(params), specs) if sp.shard_dim is None)
    local = tp.serving_params(params, cfg, (1, tp_group.world),
                              tp_group.rank)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    info["int8_bytes"] = int8_bytes(local)
    return (model_zoo.build(cfg, device="cuda", dtype=dtype,
                            tp_group=tp_group), local, info)


def shard_tokens(bundle, params, reqs, shapes: set, backend: str = "auto",
                 **kw) -> dict:
    """``reqs`` through ``make_scheduler`` at f32 on the card: the tokens,
    every ``int8_matmul`` problem recorded into ``shapes``."""
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.serve.scheduler import make_scheduler
    kernel = ti8.int8_matmul

    def recording(x, q, scale, block=256):
        shapes.add((x.shape[0], q.shape[0], q.shape[1], x.dtype))
        return kernel(x, q, scale, block)

    sched = make_scheduler(bundle, params, backend=backend,
                           num_slots=DENSE_SLOTS, max_len=DENSE_WINDOW,
                           block_size=PAGED_BLOCK, prefill_chunk=PAGED_CHUNK,
                           dtype=torch.float32, device="cuda", **kw)
    ti8.int8_matmul = recording
    try:
        return {c.rid: c.tokens for c in sched.run(reqs)}
    finally:
        ti8.int8_matmul = kernel


def shard_one_process(seed: int, before=None) -> dict:
    """Phase 19's one process: 19a's llama-1b and 19b's mistral-nemo-12b
    through the paged scheduler alone at bf16 (timed, ``paged_run``), and
    the f32 token references at 2 layers (19a paged and slot, 19b paged).
    ``before()`` waits until the ranks have left phase 18, so nothing else
    runs on the card while this times."""
    if before is not None:
        before()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    out = {"t_start": t0}
    for tag, arch, layers in (("19a", SHARD_ARCH, SHARD_LAYERS),
                              ("19b", TP_ARCH, SHARD_TP_LAYERS)):
        cfg = shard_config(arch, layers)
        bundle, params, info = shard_model(cfg, seed, torch.bfloat16)
        reqs = dense_requests(seed, cfg.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        run = paged_run(bundle, params, reqs, slots=DENSE_SLOTS,
                        window=DENSE_WINDOW, shapes=set(),
                        num_blocks=shard_blocks(),
                        per_call=7 * layers + 1, roofline=False)
        out[tag] = {**run, **info}
        del bundle, params
        gc.collect()
        torch.cuda.empty_cache()
        f32 = shard_config(arch, SHARD_F32_LAYERS)
        bundle, params, _ = shard_model(f32, seed, torch.float32)
        out[tag]["f32_paged"] = shard_tokens(bundle, params, reqs, set())
        if tag == "19a":
            out[tag]["f32_slot"] = shard_tokens(bundle, params, reqs, set(),
                                                backend="slot")
        del bundle, params
        gc.collect()
        torch.cuda.empty_cache()
    out["s"] = time.monotonic() - t0
    return out


def shard_rank(comm, seed: int) -> dict:
    """Phase 19 on this rank. 19a: llama-1b with the weights replicated,
    its paged pool split on the ``(1, 2)`` mesh (8 of each 16-token block
    a rank), bf16, 11a's traffic; then the f32 token gates at 2 layers:
    the paged pool on ``(1, 2)``, the slot pool on ``(2, 1)`` (the slots
    over data). 19b: mistral-nemo-12b tensor-parallel on ``(1, 2)``, the
    same traffic, bf16; then its f32 gate at 2 layers. Rank 0 then holds
    every ``int8_matmul`` problem of the phase against its plain
    version."""
    from repro_torch.distributed.comm import mesh_comms
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import shard
    t0 = time.monotonic()
    groups = mesh_comms(comm, (1, 2))
    by_data = mesh_comms(comm, (2, 1))
    mesh = make_mesh((1, 2))
    out = {"rank": comm.rank, "seconds": {}}
    shapes: set = set()
    launches = Counter()
    for tag, arch, layers in (("19a", SHARD_ARCH, SHARD_LAYERS),
                              ("19b", TP_ARCH, SHARD_TP_LAYERS)):
        t = time.monotonic()
        tp_group = groups.model if tag == "19b" else None
        cfg = shard_config(arch, layers)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        bundle, params, info = shard_model(cfg, seed, torch.bfloat16,
                                           tp_group)
        kw = {} if tp_group is not None else {
            "shardings": shard.paged_pool_sharding(
                bundle, shard_blocks(), PAGED_BLOCK, mesh),
            "group": groups}
        groups.model.reset_stats()
        run = paged_run(bundle, params, dense_requests(seed, cfg.vocab_size),
                        slots=DENSE_SLOTS, window=DENSE_WINDOW, shapes=shapes,
                        num_blocks=shard_blocks(), per_call=7 * layers + 1,
                        sched_kw=kw, comm=groups.model, roofline=False)
        launches.update(run["launches"])
        out[tag] = {**run, **info,
                    "rank_peak_gib": torch.cuda.max_memory_allocated()
                    / 2 ** 30}
        del bundle, params
        gc.collect()
        torch.cuda.empty_cache()
        f32 = shard_config(arch, SHARD_F32_LAYERS)
        bundle, params, _ = shard_model(f32, seed, torch.float32, tp_group)
        reqs = dense_requests(seed, f32.vocab_size)
        if tag == "19a":
            out[tag]["f32_paged"] = shard_tokens(
                bundle, params, reqs, shapes,
                shardings=shard.paged_pool_sharding(
                    bundle, shard_blocks(), PAGED_BLOCK, mesh,
                    torch.float32), group=groups)
            out[tag]["f32_slot"] = shard_tokens(
                bundle, params, reqs, shapes, backend="slot",
                shardings=shard.pool_sharding(
                    bundle, DENSE_SLOTS, DENSE_WINDOW,
                    make_mesh((2, 1)), torch.float32), group=by_data)
        else:
            out[tag]["f32_paged"] = shard_tokens(bundle, params, reqs,
                                                 shapes)
        del bundle, params
        gc.collect()
        torch.cuda.empty_cache()
        out["seconds"][tag] = time.monotonic() - t
    out["launches"] = dict(launches)
    comm.barrier()
    if comm.rank == 0:
        t = time.monotonic()
        out["check"] = check_shapes(shapes, seed)
        out["seconds"]["check"] = time.monotonic() - t
    comm.barrier()         # nothing else on the card while rank 0 checks
    out["wall_s"] = time.monotonic() - t0
    return out


def shard_analytic(cfg, tag: str, B: int) -> dict:
    """A decode dispatch's collectives on the model group, from the
    shapes: 19a's held-keys combine, one max and one sum all-reduce a
    layer of (B, H, 1) and (B, H, 1 + hd) float32; 19b's two float32
    all-reduces a layer of (B, 1, d) (attention, FFN) and two
    all-gathers, the embedding's d/2 columns and the head's V/2 logits in
    bf16."""
    L, H, hd, d = (cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim,
                   cfg.d_model)
    if tag == "19a":
        return {"all_reduce_max": (L, L * B * H * 4),
                "all_reduce": (L, L * B * H * (1 + hd) * 4)}
    return {"all_reduce": (2 * L, 2 * L * B * d * 4),
            "all_gather": (2, B * (d // 2) * 2 + B * (cfg.vocab_size // 2)
                           * 2)}


def shard_result(ranks: list, one: dict, t19: float) -> dict:
    """Phase 19's gates and lines."""
    problems, res = [], {"card": card()}
    log(f"== phase 19: sharded serving in phase 17's ranks on cuda:0 over "
        f"gloo: {SHARD_ARCH} at {SHARD_LAYERS} of 24 layers with the "
        f"weights replicated and the paged pool split on (1, 2) (19a), "
        f"{depth_cut(TP_ARCH)} tensor-parallel on (1, 2) (19b); 11a's "
        f"traffic ({DENSE_SLOTS} slots, {DENSE_REQS} requests of "
        f"{DENSE_PROMPT[0]}-{DENSE_PROMPT[1]} tokens, {DENSE_NEW} new)")
    log("card:", nvidia_smi_line())
    for tag, arch, layers in (("19a", SHARD_ARCH, SHARD_LAYERS),
                              ("19b", TP_ARCH, SHARD_TP_LAYERS)):
        cfg = shard_config(arch, layers)
        o = one[tag]
        want = shard_analytic(cfg, tag, DENSE_SLOTS)
        rows = []
        for r in ranks:
            run = r["19"][tag]
            share, first = first_divergence(run["tokens_by_rid"],
                                            o["tokens_by_rid"])
            steps = run["collectives_by_dispatch"]["_step"]
            if not steps:
                problems.append(f"{tag} rank {r['rank']}: no decode-only "
                                "dispatch")
                steps = [{}]
            per = {}
            for op, (calls, nbytes) in want.items():
                got = {tuple(v.get(op, [0, 0])[:2]) for v in steps}
                per[op] = {"calls": calls, "bytes": nbytes,
                           "measured": sorted(got),
                           "median_ms": statistics.median(
                               v.get(op, [0, 0, 0.0])[2] * 1e3
                               for v in steps)}
                if got != {(calls, nbytes)}:
                    problems.append(f"{tag} rank {r['rank']} {op} a decode "
                                    f"dispatch {sorted(got)}, analytic "
                                    f"{(calls, nbytes)}")
            extra = set().union(*map(set, steps)) - set(want)
            if extra:
                problems.append(f"{tag} rank {r['rank']}: collectives {extra}"
                                " beyond the analytic ones")
            if run["pool_bytes"] * 2 != o["pool_bytes"]:
                problems.append(f"{tag} rank {r['rank']} pool "
                                f"{run['pool_bytes']} B, one process "
                                f"{o['pool_bytes']} B")
            rep = run.get("int8_bytes_replicated", 0)
            if tag == "19b" and (run["int8_bytes"] - rep) * 2 != \
                    o["int8_bytes_whole"] - rep:
                problems.append(f"19b rank {r['rank']} INT8 "
                                f"{run['int8_bytes']} B ({rep} B whole on "
                                f"every rank) of {o['int8_bytes_whole']}")
            for kind in ("f32_paged", "f32_slot"):
                if kind in o and run[kind] != o[kind]:
                    problems.append(f"{tag} rank {r['rank']} {kind} tokens "
                                    "differ from the one process's")
            row = {"rank": r["rank"], "tokens_per_s": run["tokens_per_s"],
                   "mean_ttft_s": run["mean_ttft_s"],
                   "median_decode_ms": run["median_decode_step_ms"],
                   "median_append_ms": run["median_append_ms"],
                   "median_fused_ms": run["median_fused_ms"],
                   "dispatches": run["dispatches"],
                   "launches_per_decode_dispatch":
                       run["launches_per_decode_dispatch"],
                   "pool_bytes": run["pool_bytes"],
                   "peak_gib": run["rank_peak_gib"],
                   "bf16_tokens_equal_share": share,
                   "first_divergence": first, "collectives_a_decode": per,
                   "f32_tokens_equal": all(run[k] == o[k] for k in
                                           ("f32_paged", "f32_slot")
                                           if k in o)}
            if tag == "19b":
                row.update(int8_bytes=run["int8_bytes"],
                           int8_bytes_whole=o["int8_bytes_whole"],
                           int8_bytes_replicated=rep)
            rows.append(row)
            log(f"  {tag} rank {r['rank']}: {run['tokens_per_s']:.1f} tok/s "
                f"(one process {o['tokens_per_s']:.1f}), mean TTFT "
                f"{run['mean_ttft_s']:.3f} s ({o['mean_ttft_s']:.3f}), "
                f"median decode dispatch {run['median_decode_step_ms']:.2f} "
                f"ms ({o['median_decode_step_ms']:.2f}), pool "
                f"{run['pool_bytes'] / 2**20:.2f} MiB ({o['pool_bytes'] / 2**20:.2f}), "
                f"peak {run['rank_peak_gib']:.2f} GiB, bf16 tokens equal "
                f"{share:.3f} (first divergence {first}), f32 tokens "
                f"equal {row['f32_tokens_equal']}; model group a decode "
                "dispatch: " + ", ".join(
                    f"{op} {v['measured']} calls/bytes (analytic "
                    f"{v['calls']}, {v['bytes']}), {v['median_ms']:.2f} ms"
                    for op, v in per.items())
                + (f"; INT8 {run['int8_bytes']} B of "
                   f"{o['int8_bytes_whole']} (the matrices' half and the "
                   f"{rep} B of norm scales whole)" if tag == "19b" else "")
                + f"; launches a decode dispatch "
                f"{run['launches_per_decode_dispatch']}")
        res[tag] = {"layers": layers, "ranks": rows,
                    "one_process": {k: o[k] for k in (
                        "tokens_per_s", "mean_ttft_s",
                        "median_decode_step_ms", "median_append_ms",
                        "median_fused_ms", "pool_bytes", "dispatches",
                        "peak_gib")},
                    "analytic_collectives_a_decode": want}
    c = ranks[0]["19"]["check"]
    res.update(check=c, launches=dict(sum(
        (Counter(r["19"]["launches"]) for r in ranks), Counter())),
        one_process_s=one["s"],
        ranks_s=[r["19"]["wall_s"] for r in ranks],
        wall_s=time.monotonic() - t19)
    log(f"  phase 19: {res['wall_s']:.1f} s: the one process "
        f"{one['s']:.1f} s, then the ranks {res['ranks_s']} s (19a "
        f"{[r['19']['seconds']['19a'] for r in ranks]}, 19b "
        f"{[r['19']['seconds']['19b'] for r in ranks]}, rank 0's "
        f"{c['checked_problems']} int8_matmul problems "
        f"{ranks[0]['19']['seconds']['check']:.1f} s); int8_matmul "
        f"launches in both ranks' bf16 runs {res['launches']}")
    if problems:
        raise AssertionError("phase 19: " + "; ".join(problems))
    return res


def add_sharded(kernels: dict, sh: dict) -> None:
    """Phase 19's part of the kernels line: ``int8_matmul``'s launches in
    both ranks' bf16 runs and the phase's problems against the plain
    version, and the phase's summary."""
    k = next(k for k in kernels["kernels"] if k["name"] == "int8_matmul")
    n = sh["launches"].get("int8_matmul", 0)
    k["launches"] += n
    k["launches_by_path"]["sharded_serving"] = n
    k["sharded_serving"] = sh["check"]
    k["max_abs_err"] = max(k["max_abs_err"], sh["check"]["check_max_abs_err"])
    kernels["sharded_serving"] = {t: sh[t] for t in (
        "card", "wall_s", "19a", "19b")}


def write_analysis() -> None:
    """Every timed step's roofline as one table, and the run's rooflines
    and recorded kernel tables written to ``build/analysis.json``
    (``python -m repro_torch.analysis.report build/analysis.json``)."""
    from repro_torch.analysis import report
    log(f"  rooflines of the timed steps ({card()}):")
    for line in report.roofline_table(ANALYSIS["roofline"]).splitlines():
        log("    " + line)
    out = Path(__file__).resolve().parent / "build" / "analysis.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(ANALYSIS, indent=1))
    log(f"  written to {out}; the rooflines and the extra recorded steps "
        f"took {ANALYSIS['seconds']:.1f} s of the run")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default="",
                    help="comma-separated phases to run (e.g. 1,12): a "
                         "partial run for development, which prints no "
                         "kernels line and no result")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    # plain versions and library calls in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    if args.only:
        phases = {"1": phase_environment, "2": phase_kernels,
                  "3": phase_serving, "4": phase_parity,
                  "5": phase_training, "6": phase_flash,
                  "7": phase_unfused, "8": phase_training_7b,
                  "9": phase_finetune, "11": phase_dense_variants,
                  "12": phase_moe, "13": phase_mla, "14": phase_xlstm,
                  "15": phase_zamba, "16": phase_encdec}
        names = args.only.split(",")
        for name in names:
            if name in ("17", "18", "19"):
                continue
            fn = phases[name]
            fn() if name == "1" else fn(args.seed)
        ranked = tuple(n for n in names if n in ("17", "18", "19"))
        if ranked:          # phases 18 and 19 run in phase 17's ranks
            phase_data_parallel(args.seed, ranked)
        write_analysis()
        log(f"== phases {args.only} passed in {time.monotonic() - t0:.1f} s")
        return 0
    phase_environment()
    rows, step, step_by, max_abs, max_rel = phase_kernels(args.seed)
    serving = phase_serving(args.seed)
    parity = phase_parity(args.seed)
    training = phase_training(args.seed)
    flash_rows, flash_serving, flash_parity = phase_flash(args.seed)
    unfused = phase_unfused(args.seed)
    training_7b = phase_training_7b(args.seed)
    finetune = phase_finetune(args.seed)
    paged = {"serving": phase_paged(args.seed, serving),
             "parity": phase_paged_parity(args.seed)}
    dense = phase_dense_variants(args.seed)
    moe = phase_moe(args.seed)
    mla = phase_mla(args.seed)
    xl = phase_xlstm(args.seed)
    zb = phase_zamba(args.seed)
    ed = phase_encdec(args.seed)
    dp = phase_data_parallel(args.seed)
    log(f"  serving, route off / flash route: tokens/s "
        f"{serving['tokens_per_s']:.1f} / {flash_serving['tokens_per_s']:.1f}"
        f", mean TTFT {serving['mean_ttft_s']:.3f} / "
        f"{flash_serving['mean_ttft_s']:.3f} s, median decode step "
        f"{serving['median_decode_step_ms']:.2f} / "
        f"{flash_serving['median_decode_step_ms']:.2f} ms, the "
        f"{serving['stats']['prefills']} prefills "
        f"{serving['prefill_ms_total']:.1f} / "
        f"{flash_serving['prefill_ms_total']:.1f} ms, launches a prefill "
        f"int8_matmul {7 * num_layers() + 1} / {7 * num_layers() + 1}, "
        f"flash_attention 0 / {num_layers()}")
    write_analysis()
    log(f"== all phases passed in {time.monotonic() - t0:.1f} s")
    print(json.dumps(kernels_json(rows, step, step_by, max_abs, max_rel,
                                  serving, parity, training, flash_rows,
                                  flash_serving, flash_parity, unfused,
                                  training_7b, finetune, paged, dense,
                                  moe, mla, xl, zb, ed, dp)))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernels_json(rows, step, step_by, max_abs, max_rel, serving, parity,
                 training, flash_rows, flash_serving, flash_parity,
                 unfused, training_7b, finetune, paged, dense, moe,
                 mla, xl, zb, ed, dp) -> dict:
    """The ``kernels`` line: every kernel with its launches on the main
    paths, errors against its plain version, and times beside its bound;
    the three training kernels also carry their LLaMA-7B rows
    (``llama_7b``: per-shape rows and one steady step's sums) and their
    LLaMA-7B fine-tune rows at rank 8 (``llama_7b_finetune``);
    ``int8_matmul`` and ``int8_matmul_t`` their phase 11 serving launches,
    ``int8_matmul_t`` the tied head's rows (``tied_head``); the three
    their phase 12 and 13 launches (the expert grid axis counted apart as
    ``*_batched``) and both INT8 matmuls the expert problems' rows
    (``moe``, ``mla``); the three their phase 14 launches (xLSTM serving
    and training), ``int8_matmul`` phase 14's serving, parity and the
    sLSTM gates' f32-x rows (``xlstm``); the three their phase 15 launches
    (the hybrid's serving and training), ``int8_matmul`` phase 15's
    serving and parity (``zamba``), ``flash_attention`` 15c's prefills and
    its d = 80 rows (``head_dim_80``); the three their phase 16 launches
    (the encoder-decoder's serving and training), ``int8_matmul`` phase
    16's serving, parity and cross K/V timing (``encdec``),
    ``flash_attention`` 16c's prefills and its d = 64 rows
    (``head_dim_64_encdec``)."""
    layers = num_layers()
    flash_pick, flash_f32 = (
        next(r for r in flash_rows if (r["B"], r["S"], r["dv"], r["causal"],
                                       r["dtype"]) == (8, 512, 64, True, dt))
        for dt in ("bfloat16", "float32"))

    def total(rs, mult, keys=("ms", "plain_ms", "bound_ms", "library_ms")):
        return {k: None if any(r[k] is None for r in rs)
                else sum(r[k] * n for r, n in zip(rs, mult)) for k in keys}

    chain_i4 = [r for r in unfused["int4_matmul"] if r["on_path"]]
    chain_sr = [r for r in unfused["sr_requant"] if r["on_path"]]
    bq = unfused["blockwise_quant"]
    # a training step's int8_matmul calls at M = 8 x 256, bf16 x: the
    # forward (7 a layer and the head) and the recompute (7 a layer)
    pick = {(r["K"], r["n_real"]): r for r in rows
            if r["M"] == 2048 and r["x"] == "bfloat16"}
    fwd = {(2048, 2048): 8 * layers, (2048, 5461): 4 * layers,
           (5461, 2048): 2 * layers, (2048, 32000): 1}
    train_step = {k: sum(pick[s][k] * n for s, n in fwd.items())
                  for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    tl = training["launches"]
    tk = training["train_kernels"]
    sums = training["train_kernel_step_sums"]
    l7 = training_7b["launches"]
    tk7 = training_7b["train_kernels"]
    sums7 = training_7b["train_kernel_step_sums"]
    i8_7b = training_7b["int8_matmul"]
    ft_cli, ft7 = finetune["cli"], finetune["llama_7b"]
    lc, lf = ft_cli["launches"], ft7["launches"]
    tkf, sumsf, i8f = ft7["train_kernels"], ft7["train_kernel_step_sums"], \
        ft7["int8_matmul"]
    ps = paged["serving"]
    dl = {n: sum(r["launches"].get(n, 0) for r in dense["serving"].values())
          for n in ("int8_matmul", "int8_matmul_t")}
    ms_, mt_ = moe["serving"]["launches"], moe["training"]["launches"]
    ls_, lt_ = mla["serving"]["launches"], mla["training"]["launches"]
    xs_, xt_ = xl["serving"]["launches"], xl["training"]["launches"]
    zs_, zt_ = zb["serving"]["launches"], zb["training"]["launches"]
    zf = zb["flash"]
    es_, et_ = ed["serving"]["launches"], ed["training"]["launches"]
    ef = ed["flash"]
    dpl, dpk = dp["launches"], dp["train_kernels"]
    dp_info = {k: dp[k] for k in (
        "card", "world", "layers", "backend", "wall_s", "ranks_s",
        "steady_step_ms_17a", "steady_step_ms_17b",
        "steady_step_ms_one_process", "refresh_step_s",
        "refresh_subspace_s", "payload_bytes", "steady_collectives",
        "opt_bytes_17a", "opt_bytes_17b", "peak_gib_17b",
        "codes_equal_17b_17a", "step0_rel_diff",
        "restored_step3_rel_diff")}

    def xl_paths(name):
        return {"xlstm_serving": xs_.get(name, 0),
                "xlstm_training": xt_.get(name, 0),
                "zamba_serving": zs_.get(name, 0),
                "zamba_training": zt_.get(name, 0),
                "encdec_serving": es_.get(name, 0),
                "encdec_training": et_.get(name, 0)}

    def grid_paths(name):
        # each MoE path's launches, 2-D and batched together, and the
        # batched (expert grid axis) apart
        out = {}
        for path, got in (("moe_serving", ms_), ("moe_training", mt_),
                          ("mla_serving", ls_), ("mla_training", lt_)):
            out[path] = got.get(name, 0) + got.get(name + "_batched", 0)
            out[path + "_batched"] = got.get(name + "_batched", 0)
        return out

    moe_paths = {n: grid_paths(n) for n in ("int8_matmul", "int8_matmul_t")}
    mk, lk = moe["kernels"], mla["kernels"]
    moe_timed = ("E 128 expert problems, per-call median of 20 after an L2 "
                 "flush; per_expert_ms: the same work as 128 launches of "
                 "the 2-D kernel (median of 10); library: one torch.bmm on "
                 "the bf16 stack dequantized beforehand")
    mla_timed = moe_timed.replace("128", "256") + (
        "; plain: the plain version 32 experts a call")

    def ft_paths(name):
        return {"finetune_cli": lc.get(name, 0),
                "finetune_7b": lf.get(name, 0)}

    def by(rs):
        return "bytes" if all(r["bound_by"] == "bytes" for r in rs) \
            else "operations"

    kernels = {"kernels": [{
        "name": "int8_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/int8_matmul.py:85",
        "launches": serving["launches"].get("int8_matmul", 0)
        + tl.get("int8_matmul", 0) + l7.get("int8_matmul", 0)
        + sum(ft_paths("int8_matmul").values()) + ps["launches"]
        + dl["int8_matmul"] + sum(
            moe_paths["int8_matmul"][k] for k in (
                "moe_serving", "moe_training", "mla_serving",
                "mla_training")) + sum(xl_paths("int8_matmul").values())
        + dpl["int8_matmul"],
        "launches_by_path": {"serving": serving["launches"].get(
            "int8_matmul", 0), "training": tl.get("int8_matmul", 0),
            "training_7b": l7.get("int8_matmul", 0),
            **ft_paths("int8_matmul"), "paged_serving": ps["launches"],
            "dense_variants_serving": dl["int8_matmul"],
            **moe_paths["int8_matmul"], **xl_paths("int8_matmul"),
            "dp_training": dpl["int8_matmul"]},
        "max_abs_err": max([max_abs, serving["check_max_abs_err"],
                            ps["check_max_abs_err"],
                            moe["serving"]["check_max_abs_err"],
                            moe["serving"]["batched"]["check_max_abs_err"],
                            mla["serving"]["check_max_abs_err"],
                            mla["serving"]["batched"]["check_max_abs_err"],
                            xl["serving"]["check_max_abs_err"],
                            zb["serving"]["check_max_abs_err"],
                            ed["serving"]["check_max_abs_err"]]
                           + [r["max_abs_err"] for r in xl["slstm_gates"]]
                           + [r["max_abs_err"]
                              for r in i8_7b["per_shape"]
                              + i8f["per_shape"]
                              + dpk["int8_matmul"]["per_shape"]
                              + mk["int8_matmul_batched"]
                              + lk["int8_matmul_batched"]]
                           + [r["check_max_abs_err"]
                              for r in dense["serving"].values()]),
        "max_rel_err": max([max_rel, serving["check_max_rel_err"],
                            ps["check_max_rel_err"],
                            moe["serving"]["check_max_rel_err"],
                            moe["serving"]["batched"]["check_max_rel_err"],
                            mla["serving"]["check_max_rel_err"],
                            mla["serving"]["batched"]["check_max_rel_err"],
                            xl["serving"]["check_max_rel_err"],
                            zb["serving"]["check_max_rel_err"],
                            ed["serving"]["check_max_rel_err"]]
                           + [r["rel_err"] for r in xl["slstm_gates"]]
                           + [r["check_max_rel_err"]
                              for r in dense["serving"].values()]
                           + [r["rel_err"]
                              for r in mk["int8_matmul_batched"]
                              + lk["int8_matmul_batched"]]),
        "dense_variants": {
            "card": dense["card"], "wall_s": dense["wall_s"],
            "serving": dense["serving"], "f32_parity": dense["f32_parity"]},
        "moe": {"card": moe["card"], "wall_s": moe["wall_s"],
                "serving": moe["serving"], "f32_parity": moe["f32_parity"],
                "expert_rows": mk["int8_matmul_batched"],
                "timed_as": moe_timed},
        "mla": {"card": mla["card"], "wall_s": mla["wall_s"],
                "cuts": mla["cuts"], "serving": mla["serving"],
                "f32_parity": mla["f32_parity"],
                "expert_rows": lk["int8_matmul_batched"],
                "timed_as": mla_timed},
        "xlstm": {"card": xl["card"], "wall_s": xl["wall_s"],
                  "cuts": xl["cuts"], "serving": xl["serving"],
                  "f32_parity": xl["f32_parity"],
                  "slstm_gates_f32_x": xl["slstm_gates"],
                  "timed_as": ("the sLSTM gate projection (768, 3072) at "
                               "f32 x, per-call median of 20 after an L2 "
                               "flush; library: cuBLAS f32 (TF32 off) on "
                               "the weight dequantized beforehand")},
        "zamba": {"card": zb["card"], "wall_s": zb["wall_s"],
                  "split_s": zb["split_s"], "cuts": zb["cuts"],
                  "serving": zb["serving"], "f32_parity": zb["f32_parity"]},
        "encdec": {"card": ed["card"], "wall_s": ed["wall_s"],
                   "split_s": ed["split_s"], "cuts": ed["cuts"],
                   "serving": ed["serving"], "f32_parity": ed["f32_parity"],
                   "timed_as": {"cross_kv": (
                       "a decode step's 24 cross-attention K/V calls "
                       "(memory (2048, 1024) bf16 @ deq(W (1024, 1024))) "
                       "back to back on the run's weights between one "
                       "pair of events; library: cuBLAS bf16 on the same "
                       "weights dequantized")}},
        "paged_serving": dict(paged["serving"], parity=paged["parity"]),
        "data_parallel": dict(dp_info, **dpk["int8_matmul"], timed_as=(
            "the int8_matmul calls of one rank's steady step of phase 17 "
            "at M = 1024 (4 x 256 rows a rank), bf16 x, sum of per-shape "
            "medians x launches")),
        "max_rel_err_7b": max(r["rel_err"] for r in i8_7b["per_shape"]
                              + i8f["per_shape"]),
        "llama_7b_finetune": dict(i8f, timed_as=(
            "the int8_matmul calls of one LLaMA-7B fine-tune step at "
            "M = 2048 (8 x 256, accum 1), bf16 x, sum of per-shape medians "
            "x launches")),
        "llama_7b": dict(i8_7b, timed_as=(
            "the int8_matmul calls of one LLaMA-7B steady step at M = 1024 "
            "(4 x 256 a microbatch, accum 2), bf16 x, sum of per-shape "
            "medians x launches")),
        "ms": step["ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": step_by,
        "library_ms": step["library_ms"],
        "timed_as": f"the {7 * layers + 1} matmuls of one decode "
                    "step at 8 slots, bf16 x, sum of per-shape medians "
                    "(each launch after an L2 flush)",
        "decode_step_sequence": dict(step["sequence"], timed_as=(
            f"the {7 * layers + 1} matmuls of one decode step at 8 slots, "
            "bf16 x, each on its own resident weight, back to back between "
            "one pair of events; library: cuBLAS bf16 on the same weights "
            "dequantized")),
        "training_step": dict(
            train_step, factor=train_step["ms"] / train_step["library_ms"],
            design=i8_design(2048, 2048, 2048, torch.bfloat16), timed_as=(
                f"the {14 * layers + 1} matmuls of one training step at "
                "M = 2048, bf16 x, sum of phase 2's per-shape medians")),
        "design": {"M <= 16, both dtypes": i8_design(1, 2048, 2048,
                                                     torch.bfloat16),
                   "M > 16, bf16 x": i8_design(2048, 2048, 2048,
                                               torch.bfloat16),
                   "M > 16, f32 x": i8_design(2048, 2048, 2048,
                                              torch.float32)},
        "serving": {k: serving[k] for k in (
            "tokens_per_s", "mean_ttft_s", "median_decode_step_ms",
            "prefill_ms_total", "median_prefill_ms",
            "peak_gib", "launches_per_step", "checked_problems",
            "profile_step_wall_ms", "profile_step_device_ms",
            "device_idle_share", "profile_error") if k in serving},
        "path_parity_rel_err": parity,
        "per_shape": rows}, {
        "name": "int8_matmul_t", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul_t.cu",
        "replaces": "src/repro/kernels/int8_matmul.py:141",
        "launches": tl.get("int8_matmul_t", 0)
        + l7.get("int8_matmul_t", 0)
        + sum(ft_paths("int8_matmul_t").values()) + dl["int8_matmul_t"]
        + moe_paths["int8_matmul_t"]["moe_training"]
        + moe_paths["int8_matmul_t"]["mla_training"]
        + xt_.get("int8_matmul_t", 0) + zt_.get("int8_matmul_t", 0)
        + et_.get("int8_matmul_t", 0) + dpl["int8_matmul_t"],
        "launches_by_path": {"training": tl.get("int8_matmul_t", 0),
                             "training_7b": l7.get("int8_matmul_t", 0),
                             **ft_paths("int8_matmul_t"),
                             "tied_head_serving": dl["int8_matmul_t"],
                             **moe_paths["int8_matmul_t"],
                             "xlstm_training": xt_.get("int8_matmul_t",
                                                       0),
                             "zamba_training": zt_.get("int8_matmul_t", 0),
                             "encdec_training": et_.get("int8_matmul_t",
                                                        0),
                             "dp_training": dpl["int8_matmul_t"]},
        "max_abs_err": max(r["max_abs_err"] for r in tk["int8_matmul_t"]
                           + tk7["int8_matmul_t"] + tkf["int8_matmul_t"]
                           + dpk["train_kernels"]["int8_matmul_t"]
                           + dense["tied_head"]
                           + mk["int8_matmul_t_batched"]
                           + lk["int8_matmul_t_batched"]),
        "max_rel_err": max(r["rel_err"] for r in tk["int8_matmul_t"]
                           + tk7["int8_matmul_t"] + tkf["int8_matmul_t"]
                           + dense["tied_head"]),
        "moe": {"expert_rows": mk["int8_matmul_t_batched"],
                "training_check": moe["training"]["int8_matmul_t_batched"],
                "timed_as": moe_timed},
        "mla": {"expert_rows": lk["int8_matmul_t_batched"],
                "training_check": mla["training"]["int8_matmul_t_batched"],
                "timed_as": mla_timed},
        "tied_head": {"per_shape": dense["tied_head"], "timed_as": (
            "gemma-7b's tied head h (M, 3072) bf16 @ deq(E (256000, 3072))^T"
            ", per-call median after an L2 flush; library: cuBLAS bf16 "
            "h @ E^T on E dequantized beforehand"),
            "head_calls": dense["serving"]["gemma-7b"]["head_calls"],
            "launches_per_head_call":
                dense["serving"]["gemma-7b"]["launches_per_head_call"]},
        "data_parallel": {
            "step_sums": dpk["train_kernel_step_sums"]["int8_matmul_t"],
            "per_shape": dpk["train_kernels"]["int8_matmul_t"],
            "timed_as": "the dL/dx calls of one rank's phase 17 step at "
                        "M = 1024, bf16 g, sum of per-shape medians x "
                        "launches"},
        "llama_7b_finetune": {"step_sums": sumsf["int8_matmul_t"],
                              "per_shape": tkf["int8_matmul_t"],
                              "timed_as": "the dL/dx calls of one LLaMA-7B "
                                          "fine-tune step at M = 2048, bf16 "
                                          "g, sum of per-shape medians x "
                                          "launches"},
        "llama_7b": {"step_sums": sums7["int8_matmul_t"],
                     "per_shape": tk7["int8_matmul_t"],
                     "timed_as": "the dL/dx calls of one LLaMA-7B step at "
                                 "M = 1024, bf16 g, sum of per-shape "
                                 "medians x launches"},
        **sums["int8_matmul_t"], "bound_by": by(tk["int8_matmul_t"]),
        "design": {"bf16 g": mma_design(torch.bfloat16),
                   "f32 g": mma_design(torch.float32)},
        "library_call": "torch.matmul(g, W.T), bf16, on a weight "
                        "dequantized beforehand",
        "timed_as": f"the {7 * layers + 1} dL/dx calls of one training "
                    "step at M = 2048, bf16 g (as the path hands it over), "
                    "sum of per-shape medians",
        "per_shape": tk["int8_matmul_t"]}, {
        "name": "fused_qgalore_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_update.cu",
        "replaces": "src/repro/kernels/fused_update.py:234",
        "launches": tl.get("fused_qgalore_update", 0)
        + l7.get("fused_qgalore_update", 0)
        + sum(ft_paths("fused_qgalore_update").values())
        + mt_.get("fused_qgalore_update", 0)
        + lt_.get("fused_qgalore_update", 0)
        + xt_.get("fused_qgalore_update", 0)
        + zt_.get("fused_qgalore_update", 0)
        + et_.get("fused_qgalore_update", 0)
        + dpl["fused_qgalore_update"],
        "launches_by_path": {"training": tl.get("fused_qgalore_update", 0),
                             "training_7b": l7.get("fused_qgalore_update",
                                                   0),
                             **ft_paths("fused_qgalore_update"),
                             "moe_training": mt_.get("fused_qgalore_update",
                                                     0),
                             "mla_training": lt_.get("fused_qgalore_update",
                                                     0),
                             "xlstm_training": xt_.get(
                                 "fused_qgalore_update", 0),
                             "zamba_training": zt_.get(
                                 "fused_qgalore_update", 0),
                             "encdec_training": et_.get(
                                 "fused_qgalore_update", 0),
                             "dp_training": dpl["fused_qgalore_update"]},
        "max_abs_err": max(r["max_abs_err"]
                           for r in tk["fused_qgalore_update"]
                           + tk7["fused_qgalore_update"]
                           + tkf["fused_qgalore_update"]
                           + dpk["train_kernels"]["fused_qgalore_update"]
                           if r["on_path"]),
        "data_parallel": {
            "step_sums":
                dpk["train_kernel_step_sums"]["fused_qgalore_update"],
            "per_shape": dpk["train_kernels"]["fused_qgalore_update"],
            "timed_as": "the updates of one rank's phase 17 steady step "
                        "(ZeRO: on the gathered leaf), rank 512, sum of "
                        "per-shape medians x launches"},
        "llama_7b_finetune": {"step_sums": sumsf["fused_qgalore_update"],
                              "per_shape": tkf["fused_qgalore_update"],
                              "timed_as": "the updates of one LLaMA-7B "
                                          "fine-tune steady step, rank 8, "
                                          "sum of per-shape medians x "
                                          "launches"},
        "chain_vs_executor": ft_cli["chain_vs_executor"],
        "llama_7b": {"step_sums": sums7["fused_qgalore_update"],
                     "per_shape": tk7["fused_qgalore_update"],
                     "timed_as": "the updates of one LLaMA-7B steady step, "
                                 "rank 1024, sum of per-shape medians x "
                                 "launches"},
        **sums["fused_qgalore_update"],
        "bound_by": by([r for r in tk["fused_qgalore_update"]
                        if r["on_path"]]),
        "design": FUSED_DESIGN,
        "stress": [{k: r[k] for k in ("M", "N", "side", "lr", "codes_equal",
                                      "hi_only_codes_equal", "ok")}
                   for r in tk["fused_qgalore_update"] if not r["on_path"]],
        "library_note": "no single PyTorch call computes the fused update",
        "timed_as": f"the {7 * layers + 1} updates of one steady "
                    "training step, rank 512, sum of per-shape medians",
        "per_shape": tk["fused_qgalore_update"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "launches": flash_serving["launches"].get("flash_attention", 0)
        + zf["launches"]["flash_attention"]
        + ef["launches"]["flash_attention"],
        "launches_by_path": {"serving_flash_route": flash_serving[
            "launches"].get("flash_attention", 0),
            "zamba_flash_prefill": zf["launches"]["flash_attention"],
            "encdec_flash_prefill": ef["launches"]["flash_attention"]},
        "max_abs_err": max([r["max_abs_err"] for r in flash_rows
                            + zf["d80_rows"] + ef["d64_rows"]]
                           + [flash_serving["flash_check_max_abs_err"],
                              zf["flash_check_max_abs_err"],
                              ef["flash_check_max_abs_err"]]),
        "max_rel_err": max([r["rel_err"] for r in flash_rows
                            + zf["d80_rows"] + ef["d64_rows"]]
                           + [flash_serving["flash_check_max_rel_err"],
                              zf["flash_check_max_rel_err"],
                              ef["flash_check_max_rel_err"]]),
        "head_dim_80": {"card": zb["card"], "rows": zf["d80_rows"],
                        "route": {k: v for k, v in zf.items()
                                  if k != "d80_rows"},
                        "timed_as": "zamba2-2.7b's site attention at a "
                                    "single-request prefill (B 1, S 512, "
                                    "32/32 heads, d = dv = 80, causal), "
                                    "per-call median of 20 after an L2 "
                                    "flush; library: SDPA"},
        "head_dim_64_encdec": {
            "card": ed["card"], "rows": ef["d64_rows"],
            "route": {k: v for k, v in ef.items() if k != "d64_rows"},
            "timed_as": "seamless-m4t-medium's decoder self-attention at a "
                        "16a prefill (B 4, S 128, 16/16 heads, d = dv = 64,"
                        " causal), per-call median of 20 after an L2 "
                        "flush; library: SDPA"},
        **{k: flash_pick[k] * layers for k in ("ms", "plain_ms",
                                               "bound_ms", "library_ms")},
        "factor": flash_pick["ms"] / flash_pick["library_ms"],
        "bound_by": flash_pick["bound_by"],
        "design": {"bfloat16": FLASH_DESIGN[torch.bfloat16],
                   "float32": FLASH_DESIGN[torch.float32]},
        "float32": {k: flash_f32[k] for k in (
            "B", "S", "H", "d", "dv", "causal", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "tflops", "rel_err",
            "hi_only_rel")},
        "library_call": "torch.nn.functional.scaled_dot_product_attention"
                        "(is_causal=True) on the same bf16 tensors",
        "timed_as": f"the {layers} calls of one prefill at B 8, S 512, "
                    "H 32, d 64, causal bf16: 24 x the per-call median",
        "serving": {k: flash_serving[k] for k in (
            "tokens_per_s", "mean_ttft_s", "median_decode_step_ms",
            "prefill_ms_total", "median_prefill_ms", "peak_gib",
            "launches_per_prefill", "flash_checked_problems")},
        "serving_route_off": {k: serving[k] for k in (
            "tokens_per_s", "mean_ttft_s", "median_decode_step_ms",
            "prefill_ms_total", "median_prefill_ms")},
        "path_parity_rel_err": flash_parity,
        "per_shape": flash_rows}, {
        "name": "int4_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int4_matmul.cu",
        "replaces": "src/repro/kernels/int4_matmul.py:60",
        "launches": unfused["chain_launches"].get("int4_matmul", 0),
        "launches_by_path": {"unfused_update": unfused[
            "chain_launches"].get("int4_matmul", 0)},
        "max_abs_err": max(r["max_abs_err"] for r in unfused["int4_matmul"]),
        "max_rel_err": max(r["rel_err"] for r in unfused["int4_matmul"]),
        **total(chain_i4, [1] * len(chain_i4)),
        "bound_by": by(chain_i4),
        "tflops": sum(2 * r["M"] * r["K"] * r["R"] for r in chain_i4)
        / sum(r["ms"] for r in chain_i4) / 1e9,
        "factor": sum(r["ms"] for r in chain_i4)
        / sum(r["library_ms"] for r in chain_i4),
        "design": {"bf16 g": mma_design(torch.bfloat16),
                   "f32 g": mma_design(torch.float32)},
        "library_call": "torch.matmul(g, P) on a P dequantized beforehand, "
                        "f32",
        "timed_as": "the projections of one unfused step of the 2048 x 2048 "
                    "and 5461 x 2048 weights at rank 512, f32 g, sum of "
                    "per-shape medians",
        "chain": unfused["chain"],
        "per_shape": unfused["int4_matmul"]}, {
        "name": "sr_requant", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sr_requant.cu",
        "replaces": "src/repro/kernels/sr_requant.py:53",
        "launches": unfused["chain_launches"].get("sr_requant", 0),
        "launches_by_path": {"unfused_update": unfused[
            "chain_launches"].get("sr_requant", 0)},
        "max_abs_err": max(r["max_abs_err"] for r in unfused["sr_requant"]),
        "max_scale_rel_err": max(r["scale_rel_err"]
                                 for r in unfused["sr_requant"]),
        "codes_equal": all(r["codes_equal"] for r in unfused["sr_requant"]),
        **total(chain_sr, [1] * len(chain_sr)),
        "bound_by": "bytes",
        "library_note": "no single PyTorch call computes the SR requant",
        "timed_as": "the requantizations of one unfused step of the "
                    "2048 x 2048 and 5461 x 2048 weights, sum of per-shape "
                    "medians",
        "per_shape": unfused["sr_requant"]}, {
        "name": "blockwise_quant", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/blockwise_quant.cu",
        "replaces": "src/repro/kernels/blockwise_quant.py:37",
        "launches": unfused["quant_launches"].get("blockwise_quant", 0),
        "launches_by_path": {"quantize_int8": unfused[
            "quant_launches"].get("blockwise_quant", 0)},
        "max_abs_err": max(r["max_abs_err"] for r in bq),
        "bit_exact": all(r["bit_exact"] for r in bq),
        **total(bq, [r["launches"] for r in bq]),
        "bound_by": "bytes",
        "library_note": "no single PyTorch call computes the block-wise "
                        "quantization",
        "timed_as": f"quantize_int8 of the {sum(r['launches'] for r in bq)}"
                    " llama-1b weights, sum of per-shape medians x launches",
        "per_shape": bq}],
        "training": {k: training[k] for k in (
            "losses", "refresh_step_s", "refresh_svd_s", "svd_calls",
            "svd_units", "median_steady_step_ms", "tokens_per_s",
            "peak_gib", "launches_per_steady_step", "profile_step_wall_ms",
            "profile_step_device_ms", "device_idle_share", "profile_error",
            "profile_top", "checkpoint_save_s", "checkpoint_restore_s",
            "resume_steps", "resume_max_rel_diff") if k in training},
        "training_7b": {k: v for k, v in training_7b.items()
                        if k not in ("int8_matmul", "train_kernels",
                                     "train_kernel_step_sums")},
        "finetune": {"cli": {k: ft_cli[k] for k in (
            "report", "wall_s", "launches", "chain_vs_executor")},
            "llama_7b": {k: v for k, v in ft7.items()
                         if k not in ("int8_matmul", "train_kernels",
                                      "train_kernel_step_sums")}},
        "moe_training": {k: v for k, v in moe["training"].items()
                         if k != "int8_matmul_t_batched"},
        "mla_training": {k: v for k, v in mla["training"].items()
                         if k != "int8_matmul_t_batched"},
        "xlstm_training": xl["training"],
        "zamba_training": zb["training"],
        "encdec_training": ed["training"]}
    add_parallel(kernels, dp["parallel"])
    add_sharded(kernels, dp["sharded"])
    return kernels


def add_parallel(kernels: dict, par: dict) -> None:
    """Phase 18's part of the kernels line: each training kernel's
    launches in both ranks of 18a and 18b (the batched pair counted apart
    as ``*_batched``), 18a's slice problems and 18b's expert problems
    timed beside their plain versions, cuBLAS and the bound, and the
    phase's summary."""
    tp, ep = par["tp"], par["ep"]
    tk = tp["train_kernels"]
    by_name = {k["name"]: k for k in kernels["kernels"]}
    for name in TRAIN_KERNELS:
        k = by_name[name]
        t_l, e_l = tp["launches"].get(name, 0), ep["launches"].get(name, 0)
        e_b = ep["launches"].get(name + "_batched", 0)
        k["launches"] += t_l + e_l + e_b
        k["launches_by_path"].update(tp_training=t_l,
                                     ep_training=e_l + e_b,
                                     ep_training_batched=e_b)
        if name == "int8_matmul":
            rows, sums = tk["int8_matmul"]["per_shape"], \
                tk["int8_matmul"]["step_sums"]
        else:
            rows = tk["train_kernels"][name]
            sums = tk["train_kernel_step_sums"][name]
        k["tensor_parallel"] = {
            "per_shape": rows, "step_sums": sums,
            "timed_as": f"one rank's steady step of phase 18a ({TP_ARCH}, "
                        f"{TP_LAYERS} layers, the (1, 2) mesh, 8 x 256, "
                        f"rank {TP_RANK}), sum of per-shape medians x "
                        "launches"}
        k["max_abs_err"] = max([k["max_abs_err"]] + [
            r["max_abs_err"] for r in rows if r.get("on_path", True)])
        if name != "fused_qgalore_update":
            ex = [r for r in ep["batched"] if r["kernel"] == name + "_batched"]
            k["expert_parallel"] = {
                "per_shape": ex,
                "timed_as": "18b's expert problems (E 64 a rank, M = 2 x 512 "
                            "rows), fresh seeded inputs, per-call median of "
                            "20 after an L2 flush; library: one torch.bmm on "
                            "the bf16 stack dequantized beforehand"}
            k["max_abs_err"] = max([k["max_abs_err"]]
                                   + [r["max_abs_err"] for r in ex])
    kernels["parallel"] = {
        "card": par["card"], "wall_s": par["wall_s"],
        "tp": {k: v for k, v in tp.items() if k != "train_kernels"},
        "ep": {k: v for k, v in ep.items() if k != "batched"}}


if __name__ == "__main__":
    sys.exit(main())
