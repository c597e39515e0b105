#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py             # the phases below
  python3 chip_smoke.py --lr-sweep  # paths (b), (f) and (j) at γ = 1e-3,
                                    # 1e-4, 1e-5: prints whether each stays
                                    # finite
  python3 chip_smoke.py --paper-cpu PATH   # phase 6's CPU runs into PATH
                                           # (the script starts it itself)
  python3 chip_smoke.py --backbone  # phases 1, 2 and 8 alone
  python3 chip_smoke.py --ckpt      # phases 1, 2 and 9 alone
  python3 chip_smoke.py --elastic   # phases 1, 2 and 10 alone
  python3 chip_smoke.py --elastic --trace-memory   # and (aj)'s peak's live
                                           # blocks by allocation site
  python3 chip_smoke.py --families  # phases 1, 2 and 11 alone
  python3 chip_smoke.py --families-cpu PATH  # phase 11's CPU runs into PATH
                                           # (the script starts it itself)
  python3 chip_smoke.py --shards    # phases 1, 2 and 12 alone
  python3 chip_smoke.py --moe-ranks OUT   # phase 12's (au) ranks (the
                                           # script launches them itself)
  python3 chip_smoke.py --dryrun    # phases 1, 2 and 13 alone
  python3 chip_smoke.py --bf16      # phases 1, 2 and 14 alone
  python3 chip_smoke.py --fsdp      # phases 1, 2 and 15 alone
  python3 chip_smoke.py --fsdp-ranks CASE OUT   # phase 15's (bb) or (bc)
                                           # ranks (the script launches
                                           # them itself)
  python3 chip_smoke.py --fsdp-dry OUT   # phase 15's (bd) rows (the
                                           # script starts it itself)
  python3 chip_smoke.py --tp        # phases 1, 2 and 16 alone
  python3 chip_smoke.py --tp-ranks CASES DIR   # phase 16's (be)-(bh) ranks
                                           # (the script launches them)
  python3 chip_smoke.py --tp-dry OUT   # phase 16's (bi) rows (the script
                                           # starts it itself)
  python3 chip_smoke.py --main-paths [N]   # phases 1, 2 and phase 4's
                                           # training paths alone, the cut
                                           # ones at N of qwen2-0.5b's 24
                                           # layers (default CUT_LAYERS),
                                           # with each path's seconds

Phases (each prints a line; any failure raises and exits non-zero):

1. device — the card's name and power limit (nvidia-smi); no CUDA device
   is a failure, as is a directory without the repo's sources.
2. build — compile every CUDA kernel of the training paths, the
   tree-update API, the attention op and the SSD op from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, all at once).
   For ``libflash_attention`` and ``libssd_scan`` it prints each kernel's
   registers, stack frame (where ptxas spills) and local memory
   (``cuobjdump -res-usage``) and the count of tensor-core instructions
   (HMMA, HGMMA) in their SASS (``cuobjdump -sass``); a count of 0 fails
   the phase.
3. kernels — each of the twenty-three update kernels' wrappers against its
   plain PyTorch version on the card, on random fp32 inputs made with numpy
   from a seed: a moderate shape (W=4, R=65,536) and a ragged one (W=3,
   R=1,237), over the variants: with and without Δ (and B), wd 0 and 1e-4,
   fp32 and bf16 moments, nesterov on and off, β ∈ {0.5, 1}, k_eff ∈ {1,
   2, 3}; the EF round trip int8 and top-k (k ∈ {8, 64, 256}) with and
   without ref and EF, on rows with ± ties, all-zero rows and rows with
   fewer than k non-zeros mixed in; the overlap fold vrl, bvr (β ∈ {0.5,
   1}) and avg, capture on and off, the miss mask mixed 0/1 over the
   workers and pend_k ∈ {1, 2, 3}.  The hierarchy's four over (P, D, R)
   = (2, 3, 4,096), (3, 2, 1,237), (4, 1, 4,096) and (1, 4, 1,237), the
   special rows in p, wd 0 and 1e-4, k_eff ∈ {1, 2, 3}, the fold with and
   without capture and the miss mask 0, 1 and mixed over the pods.  SM3
   Adam (flat at the two flat shapes, and the hierarchy's over the four
   grids) with S ∈ {1, 2, 5} lane-stat spans (rows cut to a multiple of
   S), fp32 and bf16 mu, with and without Δ and B, and rows with a planted
   NaN in g (compared NaN for NaN); the hierarchy's momentum (nesterov on
   and off) and dense Adam steps over the four grids, fp32 and bf16
   moments, wd 0 and 1e-4; the hierarchy's EF round trips (grid form, ref
   per pod) over the four grids, int8 and top-k (k ∈ {8, 64, 256}) with
   and without ref and EF on the special rows, and once more with a NaN
   row (compared NaN for NaN where it reaches an output).  Required:
   BITWISE equality.  Then the main paths' full shape (qwen2-0.5b: W=4,
   R=1,930,240, C=256; the hierarchy's as (P, D) = (2, 2)), one rule for
   all twenty-one: bitwise again one
   worker (pod) slice at a time (to bound memory; the hierarchy's local
   steps one worker at a time), then the kernel's time in place on the whole
   buffer and its plain version's slice by slice (their temporaries at
   W=4 do not all fit beside the inputs), CUDA events, beside the bound
   (bytes moved over 3.35 TB/s, or fp32 operations over 67 TFLOP/s,
   whichever is larger; H100 SXM data sheet).  The library calls, each
   on its path's operands without Δ (or B), held to the plain version on
   worker 0 (rtol 1e-5) and timed over the worker slices:
   ``torch._fused_sgd_`` for fused_local_momentum and
   fused_hier_local_momentum, and with momentum 0 (no buffer) for
   fused_local_sgd and fused_hier_local_sgd; ``torch._fused_adamw_`` for
   fused_local_adam and fused_hier_local_adam;
   ``torch.topk(|payload|, k, dim=-1)`` beside fused_ef_topk, which does
   only the selection part of its function (a partial yardstick), and
   beside fused_ef_topk_grid on its payload.  No PyTorch call computes
   the syncs, folds and the hierarchy's other kernels, the int8 round
   trip or SM3 Adam
   (Adafactor factors with means, not SM3's max cover).  Last, level 2's
   flat round trips on the strided pod rows p[:, 0] of a (2, 2, R, C)
   buffer: bitwise pod by pod, timed beside their bound.
   The tree-update API's pair, ``vrl_local_update`` and
   ``vrl_sync_update`` (one launch per leaf), at n = 1, 105, 1000,
   2^16 + 3, (64, 64) and (4, 130, 7), fp32 and bf16 operands, views one
   element off 16-byte alignment, x̂ broadcast over 4 workers (stride 0)
   and NaNs planted (NaN for NaN); then over the full-width W = 4
   worker-stacked qwen2-0.5b tree as the per-leaf executor holds it,
   fp32 and again with bf16 p and g: bitwise leaf by leaf, the tree call
   (launches = the tree's leaf count) timed against its byte bound, the
   plain versions over the tree beside it.  No single PyTorch call
   computes either (library: none).
   The attention op's kernel, ``flash_attention`` (``kernels.mha_flash``
   and the (BH, S, D) wrapper), against its plain version to a tolerance,
   not bitwise (its online softmax sums in another order than one
   softmax): fp32 within rtol 2e-4 and atol 2e-5 (the reference's own),
   bf16 within one bf16 ulp of the output beyond that; B ∈ {1, 2}, ragged
   S ∈ {1, 100, 257, 512} padded to blocks of 64 or 128, D ∈ {16, 32, 64,
   128}, GQA groups 1, 2, 7, causal on and off, window None, 16, 64, fp32
   and bf16; scores of large magnitude (q · 10, a sharply peaked softmax)
   and D = 128 at S = 2048.  Then its path: ``kernels.mha_flash`` at the
   served models' prefill widths, (B, S, H, KVH, D) = (4, 2048, 14, 2, 64)
   for qwen2-0.5b and (4, 2048, 32, 8, 64) for granite-3-2b, fp32 and
   bf16, window None and 512 — eight calls, the launch count zeroed just
   before and read just after — each output against the plain version,
   the kernel's time (CUDA events), the plain version's, the library's in
   the same dtype (``scaled_dot_product_attention`` on the repeated (B, H,
   S, D) tensors, causal, the window as a boolean mask; timed only) and
   two bounds: the
   tensor cores' (fp32: three TF32 products for each of q·k and p·v, 12·D
   flops per kept (query, key) pair at 495 TFLOP/s; bf16: one bf16
   product for q·k and two for p·v, 6·D at 989 TFLOP/s; or 5 CUDA-core
   operations a pair at 67 TFLOP/s, which run beside them, where that is
   longer) and the first port's fp32 CUDA-core bound, 4·D per pair over
   67 TFLOP/s.
   The SSD op's kernel, ``ssd_scan`` (``kernels.ssd_chunk_scan`` and the
   (BH, L, P) wrapper), against its plain version to a tolerance, not
   bitwise: fp32 within rtol 2e-4 and atol 2e-5 · max(1, max|y|) (the
   reference tests' tolerance on unit-scale outputs, scaled with the
   output: at Q = 256 cum falls by hundreds within a chunk, and the plain
   version's fp32 prefix sums carry ulp(|cum|) into every decay), bf16
   one bf16 ulp beyond that; on numpy draws like the reference tests',
   P ∈ {16, 64}, N ∈ {8, 128}, Q ∈ {16, 64, 256} with 1 to 8 chunks, L a
   chunk multiple or ragged, B ∈ {1, 2} and H ∈ {1, 3, 32} in turn, fp32
   and bf16, an a_log that drives cum below −100 inside a chunk, the
   (BH, L, P) wrapper with a per-(batch, head) a_log, and mixed dtypes
   of x, dt, B and C.  Then its path:
   mamba2-370m's layer 0 at full width (random weights from seed 0, token
   ids (4, 2048)), its x, dt, B and C as ``ssm_forward`` makes them, one
   ``kernels.ssd_chunk_scan(chunk=256)`` with the launch count zeroed just
   before and read just after (1 launch), held against the plain version
   and the model's ``ssd_chunked`` (1e-4 · max(1, max|y|)), timed beside
   the plain version and two bounds: the tensor cores' (the chunked
   form's products — 2N per kept pair once per batch, B and C being
   shared by its heads, then per head 2P per kept pair, 2·P·N per row for
   C·stateᵀ in every chunk but the first (whose state is 0) and 2·P·N per
   row for the state update in every chunk but the last (whose state is
   never read) — as three TF32 products each, two where x or C is bf16,
   one for bf16 C·Bᵀ, at 495 TFLOP/s; or 3 CUDA-core operations per kept
   pair and head for the decay, where that is longer) and the first
   port's fp32 CUDA-core
   bound (those flops and one more a pair over 67 TFLOP/s; the sequential
   recurrence's 5·P·N per step and head printed beside it; no PyTorch
   call computes the scan: library none); then the same in bf16.
   Then both ops past the first ports' domain: ``mha_flash`` at
   stablelm-3b's (2, 2048, 32, 32, 80), kimi-k2's attention (1, 2048, 64,
   8, 112), gemma-7b's (2, 2048, 16, 16, 256) and an odd D = 72 (2, 2048,
   16, 4, 72), fp32 and bf16, causal and window 512; ``ssd_chunk_scan``
   at (B, L, H, P, N) = (2, 2048, 16, 128, 256), hymba-1.5b's (2, 2048,
   50, 64, 16) and the odd (2, 2000, 8, 80, 200), fp32 and bf16, chunk
   256 — each against its plain version at the tolerances above, timed
   beside its tensor-core bound (counted as above, at the true D); first
   the SSD wrapper's shared-memory count (``ssd_scan.smem_bytes``, which
   its domain predicate reads) against the source's own at 256 (P, N,
   chunk, dtype) points.
4. main paths — full-width qwen2-0.5b, W=4, batch 8, seq 64, on the
   synthetic non-iid stream (α = 0.05); the launch counters are zeroed
   just before each path and read just after it.  vrl_sgd + sgd (the
   reference of (z1)) and (u) run at full depth; every other path runs
   qwen2-0.5b at ``CUT_LAYERS`` of its 24 layers, at full width, so that
   the script, phase 11 added, stays within its time limit (its flat
   layout the reference's at that depth; steps, rounds and gates as
   they were).  The phase's last line gives each path's seconds:
   - vrl_sgd + sgd through ``repro_torch.launch.train`` (7 steps, k=2,
     warmup: rounds of 1, 2, 2, 2): fused_local_sgd 7 launches,
     fused_sync_vrl 4.  Every logged loss finite; after the last sync
     max|Σ_i Δ_i| ≤ 1e-4 · max|Δ| (paper §4.1: Σ_i Δ_i = 0; the mean x̂
     is rounded to fp32, which Σ_i (x̂ − p_i)/(kγ) keeps; max|Δ| is the
     largest the run logged, since that residue outlives a shrinking Δ).
   - (a) bvr_l_sgd + adam, β = 0.5 (``make_train_step(timed=True)`` and
     ``round_step``; 7 steps, rounds of 1, 2, 2, 2): fused_local_adam 7,
     fused_sync_bvr 4.  Every loss finite; after the last sync Σ_i Δ_i and
     Σ_i B_i within 1e-4 · the run's largest |Δ| (|B|) plus the fp32
     rounding of x̂ that the syncs keep: 2 W ulp(max|p|)/(k_eff γ), summed
     over the syncs (at γ = 1e-3 Adam's Δ is O(1), so that rounding is no
     longer negligible beside 1e-4 · max|Δ|).
   - (b) easgd + momentum 0.9 (8 steps, rounds of 2, 2, 2, 2; easgd
     ignores warmup): fused_local_momentum 8, fused_sync_easgd 4.  Every
     loss finite.  Then, after the counts are read, one more sync through
     the engine on the final state: worker 0's parameters and the center
     bitwise the plain version from the same pre-sync state.
   - (c) vrl_sgd + sgd, ``compress=int8``, blocking (``make_train_step(
     timed=True)``, rounds of 1, 2, 2, 2): fused_local_sgd 7,
     fused_ef_int8 4, fused_sync_vrl 4.  Every loss finite; at every sync
     Σ_i Δ_i moves by Σ_i (e_i − e'_i)/(k_eff γ) — x̂ − mean_i p_i =
     mean_i(e_i − e'_i) — within 1e-4 · the run's largest |Δ| plus the fp32
     rounding of x̂, 2 W ulp(max|p|)/(k_eff γ).
   - (d) bvr_l_sgd + sgd, β = 0.5, ``compress=topk:32``, ``overlap=True``
     (rounds of 1, 2, 2, 2): fused_local_sgd 7, fused_ef_topk 4,
     fused_fold_overlap_bvr 4 (no capture in the kernel: the EF round trip
     writes dec into pend, which the fold has read, and pend' = x̂ + dec is
     finished in place).  Every loss finite; Σ_i Δ_i and Σ_i B_i after the
     last fold within 1e-4 · the largest |Δ| (|B|) plus 2 W ulp(max|pend|)/
     (pend_k γ) per fold (Σ_i c_i = 0 holds under compression too).
   - (e) vrl_sgd + sgd, ``--overlap``, uncompressed, through
     ``repro_torch.launch.train`` (3 steps, rounds of 1, 2):
     fused_local_sgd 3, fused_fold_overlap 2 (capture in the kernel).  Every logged loss
     finite; Σ_i Δ_i ≤ 1e-4 · max|Δ| in the CLI's log.
   - (f) local_sgd + sgd, ``overlap=True`` (rounds of 2, 2, 2, 2) at
     ``LOCAL_OVERLAP_LR``: fused_local_sgd 8, fused_fold_overlap_avg 4.
     Every loss finite.
   - (g) hier_vrl_sgd + sgd on a (2, 2) grid, k1 = 2, k2 = 4, through
     ``repro_torch.launch.train`` (4 steps, rounds of 2): fused_hier_local_sgd
     4, fused_sync_hier1 2, fused_sync_hier2 1, no flat kernel.  Every
     logged loss finite; after the last round max_p max|Σ_d Δ1[p, d]| and
     max|Σ_p Δ2[p]| within 1e-4 · the run's largest |Δ1| (|Δ2|) plus the
     fp32 rounding of the means, 2 n ulp(max|p|)/(k1 γ) per round (n = D,
     P).  The device ms of every round's spans are printed.
   - (h) the same with ``--overlap`` (12 steps): fused_hier_local_sgd 12,
     fused_sync_hier1 6, fused_fold_overlap_hier2 3 (the first fold's
     correction is exactly 0, since pend = x0), fused_sync_hier2 0.
   - (i) vrl_sgd + adam + ``sm3=True``, fp32 moments (``make_train_step``,
     rounds of 1, 2, 2, 2): fused_local_adam_sm3 7, fused_sync_vrl 4.
     Every loss finite; Σ_i Δ_i as for (a); the SM3 stats' bytes beside
     the dense nu they replace.
   - (j) hier_vrl_sgd (2, 2), k1 = 2, k2 = 4, + momentum 0.9 at
     ``HIER_MOMENTUM_LR`` (8 steps, rounds of 2): fused_hier_local_momentum
     8, fused_sync_hier1 4, fused_sync_hier2 2; (k) the same with Adam, fp32
     moments: fused_hier_local_adam 8; (l) with Adam + ``sm3=True`` and bf16
     mu: fused_hier_local_adam_sm3 8.  Every loss finite; Σ_d Δ1 in every
     pod and Σ_p Δ2 as for (g); the device ms of every round's spans.
   - (m) hier_vrl_sgd (2, 2), k1 = 2, k2 = 4, ``--compress int8``,
     blocking, through ``launch.train`` (8 steps): fused_ef_int8_grid 4,
     fused_sync_hier1 4, fused_ef_int8 2 (level 2, on the pod rows),
     fused_sync_hier2 2, fused_hier_local_sgd 8.  Every logged loss finite;
     at every round Σ_d Δ1 in every pod moves by Σ_d (e1 − e1')/(k1 γ), and
     at every sync2 Σ_p Δ2 by Σ_p (e2 − e2')/(k2 γ) — the CLI's log, each
     within 1e-4 · max|Δ| plus 2 n ulp(max|p|)/(k γ), and some EF term of
     each level above twice that (so a sync that lost it would fail).
   - (n) the same grid with ``--compress int8 --compress2 topk:32
     --overlap --deadline 0.25`` (8 steps, for the script's time):
     fused_ef_int8_grid 4, fused_sync_hier1 4, fused_fold_overlap_hier2 2
     (no capture in the kernel), fused_ef_topk 2 (the compressed capture),
     fused_hier_local_sgd 8.  The per-pod misses at the folds of steps 4
     and 8 are the reference's draws, [1, 0] and [0, 1], and pend_k after
     them [5, 4], [4, 8]; Σ_d Δ1 as in (m), Σ_p Δ2
     moves at each fold by Σ_p c_p/(pend_k_p γ) (the pods' pend_k differ
     once one misses).
   - (o) ``--compress topk:32`` at both levels, blocking (4 steps):
     fused_ef_topk_grid 2, fused_ef_topk 1; the checks of (m).
   - (p) vrl_sgd + sgd with ``--backend reference`` (the per-leaf
     executor, 6 steps, k = 2, warmup: rounds of 1, 2, 2 and a one-step
     tail) and (q) hier_vrl_sgd (2, 2) with ``--backend reference
     --compress int8`` (4 steps, for the script's time),
     through ``launch.train``: no kernel
     launched (the per-leaf executor runs none, as the reference's),
     every logged loss finite, Σ_i Δ_i (for (q) each level's move by its
     EF term) as for the flat paths.
   - (r) vrl_sgd + sgd through the tree-update API: the per-leaf state
     and ``grads_fn`` of ``--backend reference``, ``vrl_local_update_tree``
     every step and ``vrl_sync_update_tree`` over the worker mean every
     k = 2 steps, 2 rounds: vrl_local_update 4 × the leaf count,
     vrl_sync_update 2 × it; losses finite, Σ_i Δ_i ≈ 0 after each sync.
   - (s), (t) the serve CLI, ``repro_torch.launch.serve --batch 4
     --prompt-len 32 --gen 32``, at full width with random weights from
     seed 0: qwen2-0.5b and the reference CLI's default granite-3-2b (40
     layers, d 2048, 2,533,531,648 parameters).  No
     kernel launched (the reference's serving path runs none, and no
     model calls mha_flash).  The output is (4, 64), its prompt kept,
     every token in [0, V); every prefill and decode logit finite; the
     greedy tokens are the decode logits' picks wherever their top-2
     margin is clear; decode against prefill of the same prefix, at each
     of the 31 steps, within 5e-4 · max|logit| with wq and wk × 0.1 (the
     reference's init makes attention near one-hot at depth, and two
     summation orders part: the JAX prefill and decode themselves differ
     by more than 1e-2 · max|logit| at 24 layers, d 128, tests/
     test_torch_serve.py; the port's difference under the init as drawn
     is printed, not held).  Prefill ms, decode ms per
     token, tok/s and the peak are printed.
   - (u) mamba2-370m (48 layers, d 1024, 368,227,840 parameters per
     worker) through ``repro_torch.launch.train --arch mamba2-370m
     --workers 4 --batch 4 --seq 256 --steps 3 --k 2 --lr 1e-3 --warmup``
     (one full 256-step chunk per sequence; 3 steps for the script's
     time): vrl_sgd + sgd, rounds of 1, 2: fused_local_sgd
     3, fused_sync_vrl 2 (the model's own
     ``ssd_chunked`` scan, as in the reference: no ssd_scan launch); the
     checks of the qwen2 CLI path, Σ_i Δ_i with the fp32 rounding of x̂
     added to its bound, 2 W ulp(max|p|)/(k_eff γ) per sync (Δ is O(1)
     here, where qwen2's init makes it ~1e12, so that rounding is no
     longer negligible beside 1e-4 · max|Δ|, as for the Adam paths).
   - (v) ``repro_torch.launch.serve --arch mamba2-370m --batch 4
     --prompt-len 288 --gen 32`` (a full chunk and a padded one, so the
     SSM state crosses a chunk boundary): the checks of (s), with decode
     against prefill held under the init as drawn (no attention to
     soften).
   The CLI paths' peak memory is the most allocated during a round, as
   the train paths' is (``TrainResult.round_peak_bytes``).
   γ: the model's init rule (the reference's: fan-in taken as
   ``shape[-2]``, the head count for wq/wk) makes the first gradient grow
   with depth — ~1e12 at 24 layers — so at γ = 0.05 the activations
   overflow fp32 in the round after the warmup sync and the loss is NaN.
   vrl_sgd, (a) and (i)-(l) run at γ = 0.001 (finite: the first sync
   saturates the sgd model, the loss sits at ln V; Adam normalises its
   step); (b) at ``EASGD_LR`` = 0.001 and (j) at ``HIER_MOMENTUM_LR``, the
   largest of 1e-3, 1e-4, 1e-5 that stays finite (``--lr-sweep``,
   PERF.md); (f) at
   ``LOCAL_OVERLAP_LR``, the largest of them that stays finite (at 1e-3
   the uncorrected workers of local SGD reach NaN one round after the
   stale fold, PERF.md).
5. small input — each slice at smoke size (W=2, batch 2, seq 16, rounds of
   1, 2, 2, 2, or the schedule's) on the card and on the CPU from the same
   parameters (the init with wq, wk scaled by 0.1, which keeps the
   attention soft: tests/test_torch_*.py hold the CPU runs against the JAX
   package from the same start): vrl_sgd, local_sgd, ssgd and stl_sgd
   with sgd, easgd with momentum, bvr_l_sgd with adam, vrl_sgd with adam
   and bf16 moments, vrl_sgd with adam + sm3 at ``EngineConfig(shards=2)``
   (two lane-stat spans).  fp32 GEMMs sum in other orders on the card:
   per-step losses rtol 1e-4, final params atol 1e-4, Δ and B atol
   1e-4/(k·γ).  Adam turns gradient elements that are cancelling sums
   (fp32 noise above its eps) into ±γ steps of the noise's sign, so its
   runs are held to those tolerances on all but 1 % of the elements and
   to 2γ per step on every element.  Five more slices compress or overlap:
   vrl_sgd + int8 (the configuration ``launch.train --compress int8``
   builds), ssgd + topk:4, easgd + int8:noef, local_sgd + overlap and
   vrl_sgd + int8 + overlap, each side through ``round_step``.  The
   card's GEMMs round differently, so an int8 level or a top-k pick may
   flip between the two runs: a flip moves one element of one worker's
   decompressed payload by one step of its row — max|row|/127 for int8,
   the row's kth-largest |payload| for top-k (what one run keeps and the
   other drops lies at the threshold).  So every element is held to the
   tolerances above but at most ``FLIP_CAP`` = 16 per buffer, and those,
   counted as flipped, each to twice the sum of its row's steps over the
   CPU run's communications (read from each payload as the CPU run's EF
   wrappers receive it); losses rtol 1e-4.  ssgd + topk:4 runs at
   γ = 0.01: at 0.05 its error-feedback bursts blow the smoke model up
   within 6 steps.  Then hier_vrl_sgd at W = 4, (P, D) = (2, 2), k1 = 2,
   k2 = 4, blocking and overlapped (8 steps): losses rtol 1e-4, params and
   pend atol 1e-4, Δ1 1e-4/(k1 γ), Δ2 1e-4/(k2 γ); the same grid with
   momentum 0.9, with Adam and with Adam + sm3 and bf16 mu (Adam at
   γ = 1e-3), Adam's under the Adam rule above; and one pod, (1, 4) at
   k1 = k2 = 2, BITWISE the card's flat vrl_sgd at k = 2.  Deadlines and
   the hierarchy's compressed syncs under the flip rules: vrl_sgd + int8
   + overlap at deadline 0.25 (W = 2), and hier (2, 2) with int8, with
   int8 / topk:4, with topk:4:noef at level 2 only (blocking) and with
   topk:4 overlapped at deadline 0.25 (Δ1 and Δ2 over k1 γ).  The
   per-leaf executor (``update_backend="reference"``): vrl_sgd + sgd,
   easgd + momentum, bvr_l_sgd + adam (W = 2) and hier (2, 2) + int8
   (W = 4), card against CPU under the same rules (int8's flip bound from
   the CPU run's ``ef_leaf`` payloads); and the card's per-leaf executor
   against its flat engine over one round from identical states, params
   and Δ atol 1e-5.  The serving path: the smoke qwen2-0.5b and
   granite-3-2b on the card and on the CPU from the same parameters (wq,
   wk × 0.1), full attention and a window of 8 (the ring buffer): prefill
   logits and the cache leaf by leaf, decode logits over the CPU's greedy
   tokens (atol 1e-4), the greedy tokens wherever the CPU's top-2 margin
   exceeds twice that; and mha_flash at the smoke model's attention
   shapes, the kernel against the CPU's plain version (fp32 tolerance).
   The ssm family: the smoke mamba2-370m on the card and on the CPU from
   the same parameters: prefill logits and both cache leaves (the SSM
   state, the conv window) over 40 tokens, decode logits over the CPU's
   greedy tokens (atol 1e-4) and the greedy tokens where the margin is
   clear; one vrl_sgd + sgd slice (W = 2, seq 40, 7 steps: losses rtol
   1e-4, params atol 1e-4, Δ atol 1e-4/(k γ)); and ssd_chunk_scan at the
   smoke model's shapes, the kernel against the CPU's plain version.

6. the paper — the paper's own workload (``repro_torch.paper``), each
   card run's per-step losses held within atol 1e-5 + rtol 1e-4 of the
   same run on the CPU from the same initial tree (``mlp_init(0)``),
   computed by a child process (``chip_smoke.py --paper-cpu PATH``: every
   figure's runs on the per-leaf executor) started before phase 4:
   - (w) Fig. 1 at ``run_mlp_task``'s defaults (W = 8, batch 32, γ = 0.5,
     k = 20, 300 steps, class-sharded ``feature_classification(4096, 256,
     64)``, hidden 128) for ssgd, vrl_sgd, local_sgd and easgd, through
     the flat engine's kernels (``update_backend="fused"``) and through
     the per-leaf executor (no launch): each within the bound of the
     other and of the CPU's; the fused run's launches those of the
     schedule (fused_local_sgd 300; fused_sync_vrl, fused_sync_easgd 15;
     none else); Σ_i Δ_i after each of vrl_sgd's syncs within 1e-4 ·
     max|Δ| plus the fp32 rounding of x̂ (as path (a)); VRL-SGD's final
     gap to S-SGD below Local SGD's.
   - (x) Fig. 2, the warm-up ablation, Appendix E and Appendix F through
     the flat engine's kernels (``paper.figures``, backend "fused"), each
     run (Appendix E: its distance) within the bound of the CPU's; Fig.
     2's core spread below 0.005, the warm-up's early gain positive,
     Appendix E's VRL-SGD within 1e-3 of x* at every (b, k) and Local
     SGD's bias growing, Appendix F's VRL-SGD degrading less than Local
     SGD from k = 2 to k = 100 (the reference's CPU runs show each).
   - (y) the paper's MLP (``configs/paper_mlp.py``, 2048 -> 1024 -> 200)
     over ``feature_classification()`` at its defaults (8192 × 2048, 200
     classes), W = 8, batch 32, k = 20, 300 steps, each algorithm through
     the flat engine's kernels: ms per step (host clock, synchronised),
     the engine's device ms per round (CUDA events), launches (checked
     against the schedule), peak memory and losses (finite), beside the
     card's name and power limit.  No time is asserted.

7. mesh — the distributed worker axis: ``repro_torch.launch.train
   --mesh-grid`` under ``python -m torch.distributed.run --standalone
   --nproc-per-node N`` (one process per rank, ``--loss-out`` a JSON per
   rank), each rank's block of the workers on the one card; the four
   launches start side by side (the script's time), so their step walls
   share the host's cores:
   - (z1) NCCL, world 1: phase 4's vrl_sgd + sgd flags (full width, W = 4,
     batch 8 × seq 64, k = 2, ``--warmup``, γ = 1e-3, 7 steps: rounds of 1,
     2, 2, 2), held to phase 4's one-process run of them.
   - (z2) gloo, world 2 on the one card (two workers a rank; gloo stages
     CUDA tensors through host memory): path (e)'s flags (3 steps; (e) and
     (z2) cut from 7 for the script's time; at (e)'s cut depth), held to
     path (e).
   - (z3) gloo, world 2: path (g)'s flags, hier_vrl_sgd (2, 2), k1 = 2,
     k2 = 4, 4 steps (cut from 8, with (g); at (g)'s cut depth); the rank
     grid is
     (1, 2), so every intra-pod mean
     crosses ranks and the pod group holds one rank; held to path (g).
   - (z4) gloo, world 2, the smoke width: hier (2, 2) with ``--compress
     int8 --compress2 topk:32 --overlap --deadline 0.25``, 8 steps at
     γ = 0.05, held to the same flags as one process on the card; its
     misses and pend_k to the same two ranks on the CPU (a child process
     started at the phase's start).  The CPU's losses are not held: at
     the smoke width the reference's init makes attention near one-hot,
     and card and CPU GEMMs part by ~3e-3 in the first loss, before any
     update (printed, with the step wall of the two ranks beside the
     one-process run's and the CPU ranks').
   Each path fails where a rank exits non-zero or runs another backend or
   device; any loss is non-finite or the ranks' differ; rank 0's logged
   losses (per step and the averaged model's) stand more than
   ``Z_RTOL`` = 1e-4 (relative) from the reference run's; the model-state
   all-reduces per group (the mesh's own counts) are not one per round —
   one per level per sync in the hierarchy, each on its group (data for
   sync1, pod for sync2), the overlapped round's issued async — which also
   says none ran in the local steps; a rank's kernel launches are not
   those of its block's steps and syncs; or Σ Δ breaks phase 4's bound
   after the last sync (the hierarchy's through ``hier_sums``; at (z4)'s
   γ the EF term need not stand clear of the rounding).  Each rank's
   collective counts and bytes, its sync (or begin / fold) spans (device
   ms, labelled NCCL world 1 or gloo through host memory), peak memory
   and step wall are printed.  One card cannot show multi-card timing:
   NCCL refuses two ranks on one device, so world 2 goes through gloo.

8. backbone — the dense backbone's four further architectures
   (stablelm-3b, gemma-7b, musicgen-large, chameleon-34b); every line
   carries the card's name and power limit:
   - smoke (2 layers, d 128), the card against the CPU from the same
     parameters: forward logits (atol 1e-4); the loss (rtol 1e-5) and
     every gradient (1e-3 · max|g|) with remat off and on, through the
     full loss and the vocab-streaming one at chunk 200 (the vocabulary,
     512, is not a multiple); prefill logits and cache, four decode steps
     (frame embeddings for musicgen-large); a vrl_sgd slice through
     ``make_train_step`` (W = 2, rounds of 1, 2, 2, the kernels on the
     card, chunked_ce 200 for the tied gemma-7b): losses rtol 1e-4,
     params atol 1e-4, Δ atol 1e-4/(k γ).  GELU (musicgen-large) and
     GeGLU (gemma-7b) among them.
   - (aa) stablelm-3b (32 layers, 2,795,276,800 parameters) and (ab)
     gemma-7b (28 layers, 8,537,680,896) through ``launch.serve --batch 4
     --prompt-len 32 --gen 32``; (ac) musicgen-large (48 layers) at full
     depth through ``transformer.prefill`` and ``decode_step`` over
     seeded frame embeddings (4 × 32 prompt frames, 32 decode frames; the
     CLIs refuse a codec architecture); (ad) chameleon-34b at full width
     with 8 of its 48 layers (6,610,362,368 parameters; its fp32 weights
     at full depth, 137 GB, do not fit one card) through ``serve.Engine``.
     No kernel launched.  Each: the checks of (s) (decode against prefill
     of the same prefix within 5e-4 · max|logit|, wq and wk × 0.1 in
     place), prefill ms, decode ms per token (frame), the peak and the
     weights' bytes at 3.35 TB/s.
   - (ae) stablelm-3b at full width with 4 of 32 layers (574,773,760
     parameters a worker), vrl_sgd + sgd, W = 4, batch 8 × seq 64, k = 2,
     4 steps, γ = 1e-3, through ``make_train_step`` with remat off and
     on: fused_local_sgd 4, fused_sync_vrl 2 each; the losses within 1e-6
     relative (the difference printed), both peaks and step walls.
   - (af) gemma-7b at full width with 2 of 28 layers (1,340,095,488
     parameters a worker), batch 4 × seq 64, otherwise as (ae), with
     ``chunked_ce`` 8192 (256,000 is not a multiple: the last chunk is
     padded at full width) and 0: the first step's loss within 1e-5
     relative; one step's gradients of the two losses from one state
     (``grads_fn``, W = 1, worker 0's batch) per leaf within 1e-3 ·
     max|g|; both peaks and step walls.
   ``python3 chip_smoke.py --backbone`` runs phases 1, 2 and 8 alone.

9. checkpoints and telemetry (``repro_torch.checkpoint``, ``obs``,
   ``Engine.diagnostics`` through ``launch.train``); every line carries
   the card's name and power limit:
   - (ag) qwen2-0.5b at full width, ``CKPT_LAYERS`` of its 24 layers
     (the script's time), W = 2 (one checkpoint is params +
     Δ, 2 × 2 × 0.78 GB; the directory's free space is printed first),
     batch 8 × seq 64, vrl_sgd + sgd, k = 2, γ = 1e-3, ``--steps 8
     --ckpt D --ckpt-every 4 --metrics --diag``, then ``--resume
     D/ckpt-00000004`` with the same flags: steps 5-8's losses and the
     step-8 checkpoint (every array) bitwise the uninterrupted run's;
     fused_local_sgd 8 / fused_sync_vrl 4 and 4 / 2 launches; every diag
     record's delta_residual · W within phase 4's Σ Δ bound (1e-4 ·
     max|Δ|), no alarm, no non-finite worker; the stream's events those
     of the reference.  Timed apart from the CLI: a save of the final
     state (s, GB/s; the device memory it adds, at most one leaf; its file
     bitwise the CLI's), a restore of it (s, GB/s; bitwise on the card)
     and one ``diagnostics`` pass (ms).
   - (ah) the step-4 file onto W = 4 through ``restore_resharded`` (what
     ``--resume`` calls when ``--workers`` changed; timed): right after it
     Σ_i Δ_i within phase 4's bound and the params rows the tiled saved
     rows, bitwise; two more rounds through ``make_train_step``: finite
     losses, fused_local_sgd 4 / fused_sync_vrl 2, one model-state worker
     mean a round, Σ_i Δ_i after them within phase 4's bound with the x̂
     rounding.  (``launch.train`` itself, as the reference's, refuses to
     grow W past the saved data assignment's shards: shown in (ai).)
   - (ai) the smoke width: an adam + SM3 state with bf16 moments (two
     layout shards) and a hier (2, 2) + int8 + overlap state, each saved
     after two rounds through the card's kernels and restored bitwise,
     then two rounds from the restored state bitwise two more rounds of
     the unbroken run; a gloo world-2 ``--mesh-grid`` run saving every 2
     steps (rank 0 writes the one file), resumed by one process on the
     card: its losses and final checkpoint bitwise the one-process run's;
     then ``--workers 4 --resume`` of its step-2 file: the CLI's
     resharding line printed, then its refusal, the reference's, to
     re-split two saved data shards over four workers.
   The directories are removed at the phase's end.

10. elastic runs and partial participation (``repro_torch.fault``,
   ``MemberState``, ``Engine.set_membership``, ``core.clients`` through
   ``launch.train``); every line carries the card's name and power limit:
   - (aj) qwen2-0.5b at full width and ``CUT_LAYERS`` of its 24 layers
     (the depth cut for the script's time), W = 4, batch 8 × seq 64, k =
     2, γ =
     1e-7 (at 1e-3 the init's own blow-up trips the guard's loss trend),
     12 steps with ``--membership --guard --faults
     "nan@2:3,crash@1:4,rejoin@1:8"``: the rollback, membership and fault
     events; the losses and final params and Δ bitwise its twin without
     the poison (and without the guard): the NaN round rolled back to its
     round-start state bitwise and replayed clean; max|Σ_active Δ| after
     each sync within phase 4's bound; fused_local_sgd 14 / fused_sync_vrl
     7 (twin 12 / 6); snapshot, rollback and repair seconds, the peak.
     Then worker 1 dropped, NaN planted in its params and Δ, one round:
     the survivors finite, health True; the rejoin re-seeds it within an
     ulp of x̂; Σ Δ after each repair within the bound; and 4 steps through
     ``make_train_step`` with membership on bitwise off.
   - (ak) qwen2-0.5b, ``--clients 4 --participation 0.5`` over W = 2, 6
     steps: the store's bytes (page-locked), each round's gather and
     scatter seconds, one model-state mean a round (the recentres counted
     "membership"), Σ Δ over a gathered cohort after ``recenter_drift``;
     ``--clients 2`` (M = W) bitwise the storeless run for 2 rounds.
   - (al) the smoke width (mamba2-370m's model): hier (2, 2) + int8 with a
     pod drop and a worker drop, overlapped and blocking; ``--clients 8
     --workers 4`` with crash/rejoin/killsave and ``--ckpt``, resumed
     bitwise from its step-4 store; the quickstart at 20 steps and γ 5e-5
     (at its γ 0.2 one ulp of the init parts two CPU runs); each also run
     on the CPU by a child process (``--elastic-cpu PATH DIR``, from
     step-0 starts drawn on the CPU): every loss within 1e-4.
   The directory is removed at the phase's end.

11. families — the hybrid and MoE families (``models/hybrid.py``,
   ``models/moe.py``: plain PyTorch, no kernel of their own, as the
   reference's jnp); every line carries the card's name and power limit:
   - (am) hymba-1.5b at full width and depth (32 layers, fp32) through
     ``launch.serve``: 4 × 1040 prompt tokens (past the 1024-slot window
     and four 256-token SSM chunks: the ring buffer wraps and the SSM
     state crosses chunk boundaries in prefill and decode) + 32
     generated; ``served_checks`` (decode against prefill of the same
     prefix with the attention's wq, wk × 0.1, the tree's materialised
     count); no kernel launched.
   - (ao) phi3.5-moe at full width, 4 of 32 layers (all 16 experts top-2,
     fp32, 21.8 GB), 4 × 32 + 32 through ``serve.Engine``, timed;
     ``served_checks`` on an engine of the same weights at capacity
     factor E / k (nothing dropped: a prefill of B·S tokens may drop
     entries a decode step of B tokens keeps, by the reference's
     capacity semantics).
   - (aq) kimi-k2 at full width, 1 of 61 layers (all 384 experts top-8,
     the shared expert, head_dim 112, the untied 163,840-row head), bf16
     weights (38.8 GB; the init's peak printed), 4 × 32 + 32 through
     ``serve.Engine``; layer 0's MoE output on the prefill against the
     fp32 evaluation of its kept (token, expert) pairs from the same bf16
     weights, per token within ``KIMI_TOL`` of its max|reference|.
   - (an) hymba-1.5b at full depth through ``launch.train``: W = 2, batch
     8 × 64, k = 2, 4 steps, vrl_sgd + sgd at γ = ``AN_LR``:
     fused_local_sgd 4, fused_sync_vrl 2, finite losses, Σ Δ as phase 4.
   - (ap) phi3.5-moe at full width, 1 layer, through ``make_train_step``:
     W = 2, batch 8 × 64 (capacity 80 an expert), k = 2, 4 steps, gated
     as (an).
   - (ar) the three smoke variants on the card against the CPU's runs (a
     child process, ``--families-cpu PATH``, started at the phase's
     start): prefill logits and cache leaves, decode logits over the
     CPU's tokens (atol 1e-4), the greedy tokens where the CPU's margin is
     clear; 7 vrl_sgd + sgd steps (losses rtol 1e-4, params atol 1e-4, Δ
     atol 1e-4/(k γ)); and (ap)'s first round twice more on the card,
     bitwise equal in losses, params and Δ (the dispatch's determinism).

12. shards — engine row shards on a rank grid, the shard-mapped MoE and
   the chaos check.  NCCL refuses two ranks on one card, so the
   grids of world 4 run over gloo through host memory; each rank prints
   its step wall, spans, collectives by kind and group (calls, bytes),
   launches and round peak:
   - (as) qwen2-0.5b at ``SHARD_LAYERS`` of its 24 layers, full width
     (flat 764,928 × 256; 765,952 rows at shards 2, a multiple of block
     1024 · 2), through ``launch.train --mesh-grid --shards 2``
     on (data 2 × shard 2): W = 2, batch 8 × 64, k = 2, 2 steps (one
     round, for the script's time), vrl_sgd
     + adam.  Every rank's losses bitwise the one-process run at
     ``--shards 2`` (no save, for the script's time: (at) gathers and
     holds the sharded saves); ``--shards 1`` within 1e-6 ·
     max|p|; each rank's
     params (1, 382,976, 256); one "state" all-reduce a round over its
     shard column; fused_local_adam 4, fused_sync_vrl 2 a rank, as one
     process; Σ Δ as phase 9 bounds it after every sync.
   - (at) the smoke width on (data 2 × shard 2): SM3 Adam, bf16 mu,
     ``--compress int8 --overlap --faults crash@1:3,rejoin@1:5``, 8 steps
     with saves at 4 and 8, then resumed from the step-4 save: losses,
     launches and both saves bitwise the one-process run at
     ``--shards 2``; the resumed steps 5-8 and step-8 save bitwise.
   - (au) ``models.moe_shardmap`` at phi3.5-moe's published widths (d
     4096, moe_d_ff 6400, 16 experts top-2, no shared experts, fp32,
     capacity factor E / k) on (data 2 × model 2), 256 tokens a data
     rank (``chip_smoke.py --moe-ranks OUT`` under the launcher, started
     at the phase's start beside (as) and (at)): within
     1e-5 · max|ref| of ``moe.moe_mlp`` in one process on the same 512
     tokens (the same call with TF32 products printed beside it),
     bitwise run to run, three weight gathers and the aux mean over
     "data" and one output sum over "model" a call.
   - (bl) the client store on row shards: qwen2-0.5b at
     ``SHARD_LAYERS`` of its 24 layers, full width, vrl_sgd + sgd,
     ``--workers 2 --clients 4 --participation 0.5 --mesh-grid --shards
     2`` on (data 2 × shard 2), 2 rounds of k = 1 with a save after the
     second, its ranks started at the phase's start beside (au)'s; its
     twin the same flags in one process on the card.  Gates: every rank's
     losses and launches bitwise the twin's; after each round every
     rank's row block of the store bitwise the twin's block of it
     (``--loss-out``'s ``store_digests``); each rank's store host bytes
     the twin's row-split leaves ÷ 2 and its globals whole; its
     "clients" all-gathers 1/2 of the bytes an unsharded grid's would
     move; the ranks' save (rank 0 gathers its shard peer's rows)
     restored into the twin's layout bitwise the twin's store.
   - (av) ``python -m repro_torch.scripts.chaos_smoke --device cuda
     --world 1 --cpu-init`` (NCCL), a child started at the phase's start:
     its gate, both final losses, the tolerance and the three streams'
     events.  It starts from the init a CPU run draws (seed 0): torch's
     generators differ by device, and the card's own draw is an init
     under which chaos B blows up (13.60 against the clean run's 6.24
     on an H100).  The JAX package's CLI blows up from that same start
     too (62.87 against 6.18 on the CPU, ``tests/chaos_witness.py``):
     the smoke model's instability at that init, not the port's (from
     one softened JAX start the port's three runs are the reference
     CLI's within 1e-7, ``tests/test_torch_chaos.py``).

13. dry run — the port's dry run (``launch.dryrun``: steps counted on
   meta tensors) against the card:
   - (aw) ``engine_mem`` for the ten architectures and for the CI gate's
     configuration (qwen2-0.5b, ``--shards 8 --moment-dtype bfloat16``,
     at most 700,000,000 B a device in the reference's layout, bf16
     params, which is the state the port trains: ``port`` held to the
     same budget); the card's total memory (``get_device_properties``)
     printed with its name and power limit, a failure below
     ``launch.mesh.HBM_PER_CHIP`` (80 GB); then the state the port trains
     that ``engine_mem`` sizes for padded qwen2-0.5b (24 layers, W = 4,
     Adam, bf16 params, fp32 Δ and moments) made on the card: the bytes
     of its storages equal to ``engine_mem``'s ``port`` total (the scalar
     leaves the port keeps on the host aside), and one local step of the
     port's engine on it (fused_local_adam once, bf16 parameters).
   - (ax) one round, real and counted: qwen2-0.5b padded for the single
     mesh (16 heads), 4 of 24 layers, W = 4, batch 8 × 64, one round of k
     = 2, vrl_sgd + sgd, the fused kernels.  The real round on the card
     under ``FlopCounterMode``; the same round on meta tensors through
     ``lower_one(fn_kind="round", one_process=True)``.  Gates: the FLOPs
     equal; the kernels that launched equal, by name and count, the
     kernels the dry run charged.  The card's ``max_memory_allocated``
     beside the meta peak and their ratio (recorded, not gated).
   - (ay) the roofline of (ax) (fp32 products at the CUDA cores' rate:
     TF32 is off) beside five more rounds' spans (CUDA events; each
     round's, with the SM clock, power and temperature after it, then the
     median and the spread; the round runs fp32 parameters, and the dry
     run counts it at that dtype): the products' time against ``fwd_bwd``, the
     engine pass against ``local``, the sync kernel's bound against
     ``sync``, and the round's bound against the round, each with its
     achieved share of the median; then one round under torch.profiler,
     its device time against its spans (the share the card computes).

14. bf16 parameters — the engine at the reference's parameter dtype:
   - (az) each of the twenty-one engine kernels at the main path's shape
     (4, 1,930,240, 256) (the hierarchy's at (2, 2, 1,930,240, 256)) with
     the operands of its phase-3 path, the parameters, the gradient and
     x̂ bf16, and Δ/B fp32 and (where the path has them) bf16: bitwise
     its plain version worker slice by worker slice, its time in place
     (CUDA events, 5 launches) beside phase 3's fp32 time and its byte
     bound at those operand sizes (``kernels.costs``), the plain version
     timed slice by slice, and ``torch._fused_sgd_`` on the bf16
     parameters without Δ for the sgd steps.
   - (ba) qwen2-0.5b at full width (24 layers) through
     ``make_train_step(param_dtype=torch.bfloat16)``: vrl_sgd + sgd, then
     + adam (fp32 Δ and moments), W = 4, batch 8 × 64, two rounds of k =
     3 at γ = MAIN_LR, from torch's draw with wq, wk × 0.1 (the plain
     draw's first gradients reach ~1e12 at full depth, in fp32 too).
     Gates: finite losses; after each sync Σ_i Δ_i within the bf16
     rounding of x̂ (elementwise |Σ_i Δ_i| <= Σ over the syncs of W ·
     ulp_bf16(x̂)/(k γ), 1e-4 · max|Δ| beyond it); the state's storages
     on the card equal to ``engine_mem``'s sizing of that state
     (``launch.dryrun._engine_state_bytes``, bf16 params); the launches
     (fused_local_sgd or fused_local_adam 6, fused_sync_vrl 2).  The peak
     beside phase 4's vrl_sgd + sgd (fp32 params, the same model and
     batch).

15. a worker over ranks — one VRL worker over fsdp ranks (its batch split
   over them, one gradient mean before the clip, the MoE dispatch and aux
   loss over the worker's whole batch), every rank on the one card over
   gloo (NCCL refuses two ranks on one device), its ranks
   ``chip_smoke.py --fsdp-ranks CASE OUT`` under the launcher:
   - (bb) phi3.5-moe at full width (d 4096, 16 experts top-2, moe_d_ff
     6400, vocab 32,064), 1 of 32 layers (1.56e9 parameters), bf16
     parameters and Δ, vrl_sgd + sgd, one worker over 2 fsdp ranks, batch
     8 × 64 (4 × 64 a rank), k = 1 (one step and its sync, for the
     script's time), remat on, the router's
     aux loss in the loss; then rank 0 runs the same worker on the whole
     batch in one process (the twin).  Gates: finite losses within 1e-2
     relative of the twin's; the first step's dispatches (its forward and
     the remat recompute) bitwise the twin's kept mask and slots
     (``models.moe.TRACE``; later steps' shares printed: their parameters
     differ by bf16 roundings of a gradient summed in another order); both
     ranks' params and Δ bitwise after every step (two checksums of their
     bit patterns); one "grad" all-reduce a step over the fsdp group of
     the whole gradient, fp32 on the wire.  Each rank's step walls and the
     gradient mean's walls (host clock, synchronised), its peak.
   - (bc) the smoke phi3.5-moe (capacity factor 0.5) as 2 workers × fsdp
     2 (gloo world 4), vrl_sgd + adam, fp32, clip_norm 0.5 (the first
     gradient's norm printed, a failure at or below it), launched beside
     (bb): losses within 1e-4 relative of one process with the two
     workers, the gathered params within 1e-4 · max|p| on all but 1 %
     of the elements (Adam's ±γ steps) and 2γ a step on every one.
   - (bd) (bb)'s first local step and first sync on a (1 × fsdp 2) dry
     mesh (``launch.dryrun.lower_one``): FLOPs, launches and collectives
     equal to rank 0's on the card (``FlopCounterMode``); and, in a child
     process beside (bb) and (bc) (``chip_smoke.py --fsdp-dry OUT``), the
     FSDP archs' (chameleon-34b, kimi-k2, phi3.5-moe) train_4k local and
     sync rows on the single and multi meshes, each ``ok``.
16. tensor-parallel serving — the reference's serving layout on a
   (data, model) rank grid (``launch.mesh.make_serve_mesh``: each rank
   its block of every weight by ``sharding.specs.rank_params``, its rows
   of the batch and its block of the KV cache; the collectives written by
   hand and counted as "tensor", "weights" and "moe"), every rank on the
   one card over gloo, its ranks ``chip_smoke.py --tp-ranks CASES DIR``
   under the launcher, three launches at once (the cases of one grid
   share its ranks, in turn), started beside the twins, whose card they
   leave alone until the twins are done.  Random weights from one
   seed, wq and wk × 0.1 (the full-depth check's softening, phase 5);
   each case first served by its one-process twin on the whole padded
   model, alone on the card (``serve.Engine``, greedy, batch 4 × 32 + 8;
   its tokens and each step's logits kept on the host), then by the
   ranks (``Engine(mesh=)``; each rank draws the same leaves in turn and
   keeps its blocks, so no two whole leaves are on the card at once):
   - (be) qwen2-0.5b at full width, 24 layers, over model 4, fp32: 14
     heads padded to 16 (kv 2, g' 8); 2 kv heads do not divide 4, so the
     cache splits by slots (the distributed flash-decode);
   - (bf) granite-3-2b at full width, 40 layers, over model 2, fp32: kv 8
     split;
   - (bg) phi3.5-moe at full width, 2 of 32 layers, over data 2 × model
     2, fp32: 8 experts a rank, 2 requests a data rank, the keep and drop
     over the whole batch;
   - (bh) kimi-k2's smoke model over data 2 × model 2, bf16: the 2D
     layout (d dims over "data", gathered before each product) with the
     shared expert;
   - (bj) mamba2-370m at full width and depth (48 layers) over model 4,
     fp32: ``ssm_inner`` over "model" (512 inner channels and 8 of the
     32 SSM heads a rank, their state), the conv window whole (the new x
     channels all-gathered each step); shares (be)'s launch, after it;
   - (bk) hymba-1.5b at full width, 8 of 32 layers (the script's time),
     over model 2, fp32: 30 heads padded from 25 split, kv 5 whole (the
     window's 1024 slots split, the flash-decode), 25 of the 50 SSM heads
     a rank, each branch summed before its norm in the fuse; shares
     (bf)'s launch, after it.
   Gates: every rank's greedy tokens equal its twin's rows (or, where
   they part, a near-tie of the twin's top-2 logits, printed); each
   step's logits within 1e-4 · max|twin logits| in fp32 (the mesh limit
   of PERF.md §2), within 2^-5 of each row's max in bf16; no kernel
   launched; each rank's weight bytes (``torch.cuda.memory_allocated``
   after loading) equal to the spec count within the allocator's
   rounding; each rank's prefill cache bytes equal to the spec count
   (``cache_specs``); the prefill's and a decode step's collectives equal
   to the design count (``tp_design_count``).  Printed: prefill ms,
   decode ms a token (median and spread) for the ranks and the twin, each
   rank's weight and cache bytes and peak, the collectives by kind.
   - (bi) (be)'s prefill and first decode step on a dry (1 × 4) serving
     grid (``launch.dryrun.lower_one``): FLOPs, launches and collectives
     equal to rank 0's on the card (``FlopCounterMode``); and, in a child
     process beside the ranks (``chip_smoke.py --tp-dry OUT``), kimi-k2's
     prefill_32k, decode_32k and long_500k rows on the single and multi
     meshes, each ``ok`` on the whole grid.

Then the card's name and power limit (nvidia-smi), then one JSON object
with every kernel's numbers (``launches`` from the main path that runs
it; flash_attention's and ssd_scan's from their phase-3 paths, their
times at qwen2-0.5b's width, fp32, causal, and at mamba2-370m's layer 0,
fp32, ``bound_ms`` the tensor cores', with the fp32 CUDA-core bound,
the bf16 row's numbers and the widened shapes' rows (``wide``) beside
them; each engine kernel's phase-14 numbers under ``bf16``: launches in
(ba), and ms, plain_ms, bound_ms, bound_by, library_ms with an fp32 Δ
(``delta_fp32``) and a bf16 one (``delta_bf16``, null without Δ)),
``fsdp_launches`` for the kernels (bb) runs (rank 0's), and last
``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
START = time.time()             # the script's clock, for the phase stamps
sys.path.insert(0, os.path.join(ROOT, "src"))
# the kernels' cost model: the card's rates and each kernel's bound
from repro_torch.kernels.costs import (  # noqa: E402
    COSTS, HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_FP32, PEAK_FLOPS_TF32,
    attention_cost, bound_ms, leaf_cost, ssd_cost)
FULL = (4, 1_930_240, 256)      # qwen2-0.5b flat layout at W=4
FULL_PARAMS = 494_032_768       # qwen2-0.5b's parameters per worker
MODERATE = ((4, 65_536), (3, 1_237))   # (W, R) at C = 256
LR = 0.05
CSRC = "src/repro_torch/kernels/csrc/"
VRL_REF = "src/repro/kernels/vrl_update.py:"
# kernel: (its source, the TPU kernel it replaces)
KERNEL_SOURCES = {
    "fused_local_sgd": ("vrl_update.cu", f"{VRL_REF}152"),
    "fused_local_momentum": ("vrl_update.cu", f"{VRL_REF}188"),
    "fused_local_adam": ("vrl_update.cu", f"{VRL_REF}230"),
    "fused_sync_vrl": ("vrl_update.cu", f"{VRL_REF}351"),
    "fused_sync_bvr": ("vrl_update.cu", f"{VRL_REF}388"),
    "fused_sync_easgd": ("vrl_update.cu", f"{VRL_REF}618"),
    "fused_ef_int8": ("comm_update.cu", f"{VRL_REF}743"),
    "fused_ef_topk": ("comm_update.cu", f"{VRL_REF}755"),
    "fused_fold_overlap": ("comm_update.cu", f"{VRL_REF}521"),
    "fused_fold_overlap_bvr": ("comm_update.cu", f"{VRL_REF}537"),
    "fused_fold_overlap_avg": ("comm_update.cu", f"{VRL_REF}546"),
    "fused_hier_local_sgd": ("vrl_update.cu", f"{VRL_REF}803"),
    "fused_sync_hier1": ("vrl_update.cu", f"{VRL_REF}971"),
    "fused_sync_hier2": ("vrl_update.cu", f"{VRL_REF}1003"),
    "fused_fold_overlap_hier2": ("vrl_update.cu", f"{VRL_REF}570"),
    "fused_local_adam_sm3": ("vrl_update.cu", f"{VRL_REF}302"),
    "fused_hier_local_momentum": ("vrl_update.cu", f"{VRL_REF}833"),
    "fused_hier_local_adam": ("vrl_update.cu", f"{VRL_REF}871"),
    "fused_hier_local_adam_sm3": ("vrl_update.cu", f"{VRL_REF}927"),
    "fused_ef_int8_grid": ("comm_update.cu", f"{VRL_REF}762"),
    "fused_ef_topk_grid": ("comm_update.cu", f"{VRL_REF}769"),
    "vrl_local_update": ("leaf_update.cu", f"{VRL_REF}73"),
    "vrl_sync_update": ("leaf_update.cu", f"{VRL_REF}91"),
    "flash_attention": ("flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:82"),
    "ssd_scan": ("ssd_scan.cu", "src/repro/kernels/ssd_scan.py:74")}
KERNELS = tuple(KERNEL_SOURCES)
# the kernels over the (P, D, R, C) grid, timed at HIER_FULL
HIER_KERNELS = frozenset({
    "fused_hier_local_sgd", "fused_sync_hier1", "fused_sync_hier2",
    "fused_fold_overlap_hier2", "fused_hier_local_momentum",
    "fused_hier_local_adam", "fused_hier_local_adam_sm3",
    "fused_ef_int8_grid", "fused_ef_topk_grid"})
HIER_FULL = (2, 2, 1_930_240, 256)      # the same W=4 as a (P, D) grid
# the tree-update API's pair, timed over the W=4 worker-stacked tree
LEAF_KERNELS = frozenset({"vrl_local_update", "vrl_sync_update"})
# the attention op's kernel, held to a tolerance and timed at ATTN_FULL
ATTN_KERNELS = frozenset({"flash_attention"})
# (B, S, H, KVH, D) of mha_flash at the served models' prefill widths
ATTN_FULL = {"qwen2-0.5b": (4, 2048, 14, 2, 64),
             "granite-3-2b": (4, 2048, 32, 8, 64)}
ATTN_WINDOWS = (None, 512)
# the SSD op's kernel, held to a tolerance and timed on mamba2-370m's layer
# 0 at full width: token ids (B, L), chunk Q
SSD_KERNELS = frozenset({"ssd_scan"})
SSD_FULL = (4, 2048, 256)
# the attention op past the first port's head dims: (B, S, H, KVH, D) at
# stablelm-3b's, kimi-k2's and gemma-7b's attention widths and an odd D
# (72, run on the 80-wide instantiation with zero columns)
ATTN_WIDE = {"stablelm-3b": (2, 2048, 32, 32, 80),
             "kimi-k2-1t-a32b": (1, 2048, 64, 8, 112),
             "gemma-7b": (2, 2048, 16, 16, 256),
             "odd D 72": (2, 2048, 16, 4, 72)}
# the SSD op past the first port's (P, N): (B, L, H, P, N, chunk) at the
# reference op's widest (two 64-wide P slices, four state tiles a warp),
# hymba-1.5b's SSM heads and an odd pair
SSD_WIDE = {"(P, N) = (128, 256)": (2, 2048, 16, 128, 256, 256),
            "hymba-1.5b": (2, 2048, 50, 64, 16, 256),
            "odd (P, N) = (80, 200)": (2, 2000, 8, 80, 200, 256)}
# phase 6, the paper's workload (repro_torch.paper): per-step losses held
# within atol + rtol · |want| (card vs CPU, fused vs reference executor)
PAPER_ATOL, PAPER_RTOL = 1e-5, 1e-4
PAPER_ALGS = ("ssgd", "vrl_sgd", "local_sgd", "easgd")
# each algorithm's sync kernel on the flat engine (local_sgd's average is
# a broadcast copy; S-SGD has none)
PAPER_SYNC = {"ssgd": None, "vrl_sgd": "fused_sync_vrl", "local_sgd": None,
              "easgd": "fused_sync_easgd"}
# phase 7, the distributed worker axis: ``launch.train --mesh-grid`` under
# ``torch.distributed.run``; (z4) at the smoke width
Z_RTOL = 1e-4
Z_TIMEOUT = 400                 # s, a launch at most
Z4_ARGS = ["--arch", "qwen2-0.5b", "--smoke", "--workers", "4", "--batch",
           "2", "--seq", "32", "--steps", "8", "--lr", str(LR),
           "--algorithm", "hier_vrl_sgd", "--pods", "2", "--k1", "2", "--k2",
           "4", "--compress", "int8", "--compress2", "topk:32", "--overlap",
           "--deadline", "0.25"]
Z4_LAUNCHES = {"fused_hier_local_sgd": 8, "fused_sync_hier1": 4,
               "fused_ef_int8_grid": 4, "fused_fold_overlap_hier2": 2,
               "fused_ef_topk": 2}
# phase 8, the dense backbone: the four further architectures
BACKBONE = ("stablelm-3b", "gemma-7b", "musicgen-large", "chameleon-34b")
# the smoke checks' losses: (remat, chunked_ce); the chunk does not divide
# the smoke vocabulary (512)
BACKBONE_SMOKE_CHUNK = 200
BACKBONE_LOSSES = ((False, 0), (True, 0), (False, BACKBONE_SMOKE_CHUNK),
                   (True, BACKBONE_SMOKE_CHUNK))
BACKBONE_SERVE = (4, 32, 32)    # (aa)-(ad): batch, prompt, generated
CHAMELEON_LAYERS = 8            # of 48: 137 GB of fp32 weights at full depth
STABLELM_TRAIN_LAYERS = 4       # (ae), of 32
GEMMA_TRAIN_LAYERS = 2          # (af), of 28
GEMMA_CHUNK = 8192              # (af)'s chunked_ce; 256,000 = 31.25 chunks
TRAIN8_ROUNDS = (2, 2)          # k = 2, no warm-up: 4 steps
TRAIN8_LAUNCHES = {"fused_local_sgd": 4, "fused_sync_vrl": 2}
# paths (s) and (t): the serve CLI at full width
SERVE_ARGS = ["--batch", "4", "--prompt-len", "32", "--gen", "32"]
SERVE_REL_TOL = 5e-4        # prefill vs decode, × max|logit|
HIER_MODERATE = ((2, 3, 4_096), (3, 2, 1_237), (4, 1, 4_096), (1, 4, 1_237))
MAIN_LR = 1e-3
MAIN_ARGS = ["--arch", "qwen2-0.5b", "--workers", "4", "--batch", "8",
             "--seq", "64", "--steps", "7", "--k", "2", "--lr", str(MAIN_LR),
             "--warmup"]
MAIN_LAUNCHES = {"fused_local_sgd": 7, "fused_sync_vrl": 4}
QWEN_LAYOUT = (FULL_PARAMS, FULL[1], FULL[2])
# phase 4's paths but vrl_sgd + sgd (the reference of (z1)) and (u) train
# qwen2-0.5b at CUT_LAYERS of its 24 layers, at full width, so that the
# script, phase 11 added, stays within its time; the reference's flat
# layouts (repro.core.flat.make_spec) at the depths a cut may take
CUT_LAYERS = (int(sys.argv[sys.argv.index("--main-paths") + 1])
              if "--main-paths" in sys.argv[1:-1] else 4)
QWEN_CUT_LAYOUTS = {2: (165_960_320, 649_216, 256),
                    3: (180_872_704, 706_560, 256),
                    4: (195_785_088, 764_928, 256),
                    6: (225_609_856, 881_664, 256),
                    8: (255_434_624, 998_400, 256),
                    12: (315_084_160, 1_230_848, 256),
                    24: QWEN_LAYOUT}
# paths (u) and (v): mamba2-370m (48 layers, d 1024, 32 SSD heads of 64,
# state 128, chunk 256) trains and serves at full width through the CLIs;
# (u) trains one full 256-step chunk per sequence
MAMBA = "mamba2-370m"
MAMBA_PARAMS = 368_227_840          # materialised, per worker
MAMBA_LAYOUT = (MAMBA_PARAMS, 1_438_720, 256)
# phase 11: hymba-1.5b at full depth, materialised (the reference's
# param_count overcounts its SSM and leaves out its norms), and its layout
HYMBA = "hymba-1.5b"
HYMBA_PARAMS = 1_589_669_760
HYMBA_LAYOUT = (HYMBA_PARAMS, 6_210_560, 256)
FLAT_LAYOUTS = {"qwen2-0.5b": QWEN_LAYOUT, MAMBA: MAMBA_LAYOUT,
                HYMBA: HYMBA_LAYOUT}
# 3 steps (syncs at 1 and 3 under the warm-up): cut from 7 so that the
# script, phase 16 added, keeps its time
MAMBA_ARGS = ["--arch", MAMBA, "--workers", "4", "--batch", "4", "--seq",
              "256", "--steps", "3", "--k", "2", "--lr", str(MAIN_LR),
              "--warmup"]
MAMBA_LAUNCHES = {"fused_local_sgd": 3, "fused_sync_vrl": 2}
# (v): a prompt of one full chunk and one padded chunk, so the SSM state
# crosses a chunk boundary in prefill
MAMBA_SERVE_ARGS = ["--batch", "4", "--prompt-len", "288", "--gen", "32"]
EASGD_LR = 1e-3
LOCAL_OVERLAP_LR = 1e-4
# the two further full-width paths: VRLConfig fields, rounds, launches
PATH_A = (dict(algorithm="bvr_l_sgd", inner_optimizer="adam", bvr_beta=0.5,
               comm_period=2, warmup=True, learning_rate=1e-3),
          (1, 2, 2, 2), {"fused_local_adam": 7, "fused_sync_bvr": 4})


def path_b(lr):
    return (dict(algorithm="easgd", inner_optimizer="momentum",
                 momentum=0.9, comm_period=2, learning_rate=lr),
            (2, 2, 2, 2), {"fused_local_momentum": 8, "fused_sync_easgd": 4})


def comm_paths():
    """Paths (c), (d), (f): VRLConfig fields, rounds, launches."""
    from repro_torch.comm import parse_compressor
    return {
        "c": (dict(algorithm="vrl_sgd", comm_period=2, warmup=True,
                   learning_rate=MAIN_LR,
                   compress=parse_compressor("int8")),
              (1, 2, 2, 2), {"fused_local_sgd": 7, "fused_ef_int8": 4,
                             "fused_sync_vrl": 4}),
        "d": (dict(algorithm="bvr_l_sgd", bvr_beta=0.5, comm_period=2,
                   warmup=True, learning_rate=MAIN_LR, overlap=True,
                   compress=parse_compressor("topk:32")),
              (1, 2, 2, 2), {"fused_local_sgd": 7, "fused_ef_topk": 4,
                             "fused_fold_overlap_bvr": 4}),
        "f": path_f(LOCAL_OVERLAP_LR)}


def path_f(lr):
    return (dict(algorithm="local_sgd", comm_period=2, learning_rate=lr,
                 overlap=True),
            (2, 2, 2, 2), {"fused_local_sgd": 8, "fused_fold_overlap_avg": 4})


# path (e) and its gloo twin (z2) at 3 steps (rounds 1, 2: the second fold
# the first with a correction), path (g) and (z3) at 4 (one k2 period),
# cut from 7 and 8 so that the script, phase 10 added, keeps a margin
# under its time limit: (z2) and (z3) are bound by gloo's host staging
# (1.2-3.9 s a step against 0.5-0.9 s on one process)
def with_steps(argv, n):
    """``argv`` with ``--steps n``."""
    out = list(argv)
    out[out.index("--steps") + 1] = str(n)
    return out


def cut(argv):
    """``argv`` at phase 4's cut depth (``--layers CUT_LAYERS``)."""
    return list(argv) + ["--layers", str(CUT_LAYERS)]


def qwen_cut():
    """qwen2-0.5b at phase 4's cut depth, full width."""
    from repro_torch.configs import registry
    return dataclasses.replace(registry.get_arch("qwen2-0.5b"),
                               num_layers=CUT_LAYERS)


def expected_layout(args) -> tuple:
    """The reference's flat layout (size, rows, lanes) of a CLI run's
    ``--arch`` at its ``--layers``."""
    if args.layers:
        return QWEN_CUT_LAYOUTS[args.layers]
    return FLAT_LAYOUTS[args.arch]


PATH_E_ARGS = cut(with_steps(MAIN_ARGS, 3)) + ["--overlap"]
PATH_E_LAUNCHES = {"fused_local_sgd": 3, "fused_fold_overlap": 2}
# paths (g) and (h): hier_vrl_sgd on a (2, 2) grid, k1 = 2, k2 = 4, through
# the CLI, a log line (and its invariant check) after every round
HIER_K1, HIER_K2 = 2, 4
HIER_ARGS = ["--arch", "qwen2-0.5b", "--workers", "4", "--batch", "8",
             "--seq", "64", "--lr", str(MAIN_LR), "--algorithm",
             "hier_vrl_sgd", "--pods", "2", "--k1", str(HIER_K1), "--k2",
             str(HIER_K2), "--log-every", "1"]
PATH_G = (cut(HIER_ARGS + ["--steps", "4"]),
          {"fused_hier_local_sgd": 4, "fused_sync_hier1": 2,
           "fused_sync_hier2": 1})
# 6 rounds: sync1 at each, the stale fold at steps 4, 8, 12 (the first's
# correction exactly 0: pend = x0)
PATH_H = (cut(HIER_ARGS + ["--steps", "12", "--overlap"]),
          {"fused_hier_local_sgd": 12, "fused_sync_hier1": 6,
           "fused_fold_overlap_hier2": 3})
# paths (m)-(o): the hierarchy's compressed syncs on (g)'s grid, through
# the CLI.  (m) int8 at both levels, blocking: the grid round trip at
# every sync1, the flat one over the pod rows at every sync2
PATH_M = (cut(HIER_ARGS + ["--steps", "8", "--compress", "int8"]),
          {"fused_hier_local_sgd": 8, "fused_ef_int8_grid": 4,
           "fused_sync_hier1": 4, "fused_ef_int8": 2, "fused_sync_hier2": 2})
# (n) int8 within pods, topk:32 across them, overlapped, deadline 0.25: the
# folds at steps 4 and 8 run without capture, the compressed capture is
# the flat top-k round trip; the reference's per-pod misses and the pend_k
# they leave
PATH_N = (cut(HIER_ARGS + ["--steps", "8", "--compress", "int8",
                           "--compress2", "topk:32", "--overlap",
                           "--deadline", "0.25"]),
          {"fused_hier_local_sgd": 8, "fused_sync_hier1": 4,
           "fused_ef_int8_grid": 4, "fused_fold_overlap_hier2": 2,
           "fused_ef_topk": 2})
PATH_N_MISSES = [(4, [1.0, 0.0], [5.0, 4.0]), (8, [0.0, 1.0], [4.0, 8.0])]
# (o) topk:32 at both levels, blocking, 4 steps: the grid top-k round trip
PATH_O = (cut(HIER_ARGS + ["--steps", "4", "--compress", "topk:32"]),
          {"fused_hier_local_sgd": 4, "fused_ef_topk_grid": 2,
           "fused_sync_hier1": 2, "fused_ef_topk": 1, "fused_sync_hier2": 1})
TOPK_FULL = 256 // 32           # path (d)'s k: topk:32 over 256 lanes
# paths (p) and (q): the per-leaf reference executor through the CLI; it
# launches no kernel.  (p) vrl_sgd, 6 steps, k = 2 with warmup (rounds of
# 1, 2, 2 and a one-step tail); (q) hier_vrl_sgd (2, 2) with int8 at both
# levels, 4 steps (each level's EF identity in the log; cut from 8, the
# script's time)
PATH_P = cut(MAIN_ARGS[:MAIN_ARGS.index("--steps")] + [
    "--steps", "6", "--k", "2", "--lr", str(MAIN_LR), "--warmup",
    "--backend", "reference"])
PATH_Q = cut(HIER_ARGS + ["--steps", "4", "--compress", "int8", "--backend",
                          "reference"])
# paths (i)-(l): SM3 Adam on the flat vrl_sgd, and the hierarchy's (2, 2)
# grid with momentum, Adam and SM3 Adam (bf16 mu), through make_train_step
PATH_I = (dict(algorithm="vrl_sgd", inner_optimizer="adam", sm3=True,
               comm_period=2, warmup=True, learning_rate=MAIN_LR),
          (1, 2, 2, 2), {"fused_local_adam_sm3": 7, "fused_sync_vrl": 4})
HIER_MOMENTUM_LR = 1e-3


def hier_path(inner_kw, lr, local):
    """Paths (j)-(l): VRLConfig fields, rounds of k1, launches."""
    from repro_torch.configs.base import HierConfig
    return (dict(algorithm="hier_vrl_sgd", learning_rate=lr,
                 hier=HierConfig(k1=HIER_K1, k2=HIER_K2, grid=(2, 2)),
                 **inner_kw),
            (HIER_K1,) * 4, {local: 8, "fused_sync_hier1": 4,
                             "fused_sync_hier2": 2})


def path_j(lr):
    return hier_path(dict(inner_optimizer="momentum", momentum=0.9), lr,
                     "fused_hier_local_momentum")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# the sources whose products run on the tensor cores: phase 2 prints their
# registers, stack and tensor-core instructions
TC_SOURCES = ("flash_attention", "ssd_scan")


def tensor_core_report(build) -> None:
    """Print each TC_SOURCES kernel's registers, stack frame (where ptxas
    spills) and local memory (``cuobjdump -res-usage``), and the count of
    tensor-core instructions (HMMA, HGMMA) in its library's SASS
    (``cuobjdump -sass``); fail where that count is 0."""
    bin_dir = os.path.dirname(build.nvcc())
    filt = os.path.join(bin_dir, "cu++filt")

    def dump(flag, name):
        out = subprocess.run([os.path.join(bin_dir, "cuobjdump"), flag,
                              str(build.library_path(name))],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise RuntimeError(f"cuobjdump {flag} failed for lib{name}: "
                               f"{out.stderr[-2000:]}")
        return out.stdout

    for name in TC_SOURCES:
        usage = re.findall(r"Function (\S+):\s+REG:(\d+) STACK:(\d+) "
                           r"SHARED:\d+ LOCAL:(\d+)",
                           dump("-res-usage", name))
        if not usage:
            raise AssertionError(f"cuobjdump -res-usage lists no kernel in "
                                 f"lib{name}")
        fns = [u[0] for u in usage]
        if os.path.exists(filt):        # demangled where the toolkit can
            fns = subprocess.run([filt], input="\n".join(fns),
                                 capture_output=True, text=True,
                                 timeout=60).stdout.splitlines()
        for fn, (_, regs, stack, local) in zip(fns, usage):
            short = re.sub(r"\(.*$", "", re.sub(
                r"\(int\)|\(anonymous namespace\)::|<unnamed>::|^void ", "",
                fn))
            print(f"[2 build] lib{name}: {short}: {regs} registers, {stack} "
                  f"bytes stack, {local} bytes local", flush=True)
        sass = dump("-sass", name)
        hmma = len(re.findall(r"\bHMMA\b", sass))
        hgmma = len(re.findall(r"\bHGMMA\b", sass))
        print(f"[2 build] lib{name}: {hmma} HMMA and {hgmma} HGMMA "
              f"instructions in its SASS (cuobjdump -sass)", flush=True)
        if hmma + hgmma == 0:
            raise AssertionError(f"lib{name} has no tensor-core instruction")


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# which arguments each kernel writes in place (the rest are read only)
INPLACE = {"fused_local_sgd": (0,), "fused_local_momentum": (0, 3),
           "fused_local_adam": (0, 3, 4), "fused_sync_vrl": (0, 2),
           "fused_sync_bvr": (0, 2, 3), "fused_sync_easgd": (0, 2),
           "fused_ef_int8": (2,), "fused_ef_topk": (2,),
           "fused_fold_overlap": (0, 2, 3), "fused_fold_overlap_bvr": (0, 2,
                                                                       3, 4),
           "fused_fold_overlap_avg": (0, 2), "fused_hier_local_sgd": (0,),
           "fused_sync_hier1": (0, 2), "fused_sync_hier2": (0, 2),
           "fused_fold_overlap_hier2": (0, 2, 3),
           "fused_local_adam_sm3": (0, 3, 4),
           "fused_hier_local_momentum": (0, 4),
           "fused_hier_local_adam": (0, 4, 5),
           "fused_hier_local_adam_sm3": (0, 4, 5),
           "fused_ef_int8_grid": (2,), "fused_ef_topk_grid": (2,),
           "vrl_local_update": (), "vrl_sync_update": ()}


def kg_scal(k_eff, dev):
    """k_eff·γ as the engine makes it: an fp32 product on the device."""
    return torch.full((1, 1), float(k_eff), dtype=torch.float32,
                      device=dev) * LR


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


class KernelChecks:
    """Bitwise checks of the kernels' wrappers against the plain versions;
    keeps each kernel's largest abs error and counts the checks."""

    def __init__(self, vu, tu):
        self.vu, self.tu = vu, tu
        self.err = {k: 0.0 for k in KERNELS}
        self.count = 0

    def run(self, name, args, tag, nan=False, **kw):
        """The kernel on clones of the arguments it writes, against the
        plain version on the originals; ``nan``: the inputs hold planted
        NaNs, compared NaN for NaN."""
        want = _tuple(getattr(self.tu, name)(*args, **kw))
        got = _tuple(getattr(self.vu, name)(
            *(a.clone() if i in INPLACE[name] and a is not None else a
              for i, a in enumerate(args)), **kw))
        torch.cuda.synchronize()
        self.compare(name, got, want, tag, nan=nan)

    def compare(self, name, got, want, tag, nan=False):
        if len(got) != len(want) or any((g is None) != (w is None)
                                        for g, w in zip(got, want)):
            raise AssertionError(f"{name} {tag}: outputs differ in kind")
        pairs = [(g, w) for g, w in zip(got, want) if g is not None]
        if nan:
            holes = [torch.isnan(g.float()) for g, _ in pairs]
            if not all(torch.equal(h, torch.isnan(w.float()))
                       for h, (_, w) in zip(holes, pairs)):
                raise AssertionError(f"{name} {tag}: NaNs not where the "
                                     f"plain version has them")
            if not any(h.any() for h in holes):
                raise AssertionError(f"{name} {tag}: the planted NaN did "
                                     f"not reach the outputs")
            pairs = [(g[~h], w[~h]) for h, (g, w) in zip(holes, pairs)]
        e = max((g.float() - w.float()).abs().max().item()
                for g, w in pairs)
        self.err[name] = max(self.err[name], e)
        if not all(g.dtype == w.dtype and torch.equal(g, w)
                   for g, w in pairs):
            raise AssertionError(f"{name} {tag}: not bitwise the plain "
                                 f"version (max abs err {e})")
        self.count += 1

    def full_shape(self, name, args, ndim=3, per_worker=False, **kw):
        """The kernel on each cloned (1, R, C) worker slice against the
        plain version on the same slice; ``args`` hold (W, R, C) worker
        buffers and shared operands (``ndim=4``: the hierarchy's (P, D, R,
        C) and (P, 1, R, C) buffers, pod by pod, or with ``per_worker``
        worker by worker)."""
        n = slice_count(args, ndim, per_worker)
        for i in range(n):
            # the slice's clones go with their last reference (no cycle
            # holds them): no collection between slices
            sl_args, sl_kw = worker_slice(i, args, kw, ndim, per_worker)
            self.run(name, sl_args, f"full shape, slice {i}", **sl_kw)
            del sl_args, sl_kw


def slice_count(args, ndim=3, per_worker=False):
    lead = args[0].shape
    return lead[0] * lead[1] if ndim == 4 and per_worker else lead[0]


def worker_slice(i, args, kw, ndim=3, per_worker=False):
    """Worker i's (1, R, C) slice of every (W, R, C) buffer among the
    arguments (positional and keyword) — SM3's (1, R, 1) and (1, S, C)
    stats alike — and its row of the folds' (W, 2) per-worker scalars;
    shared operands as they are.  ``ndim=4``: pod i's slice of every (P,
    D, R, C) and (P, 1, R, C) buffer and of (P, 2); with ``per_worker``,
    worker i's (1, 1, R, C) of the grid and its pod's per-pod operands
    (for the local steps, which read nothing across a pod)."""
    w, dper = args[0].shape[0], args[0].shape[1]
    pod, k = divmod(i, dper) if per_worker else (i, None)

    def one(a):
        if isinstance(a, torch.Tensor) and a.dim() == ndim:
            if k is not None and a.shape[1] == dper:
                return a[pod:pod + 1, k:k + 1]
            return a[pod:pod + 1]
        if isinstance(a, torch.Tensor) and tuple(a.shape) == (w, 2):
            return a[pod:pod + 1].clone()   # a 16-byte aligned copy
        return a
    return [one(a) for a in args], {k: one(v) for k, v in kw.items()}


def numpy_inputs(seed, w, r, c, dev, n=3):
    """n (w, r, c) fp32 buffers and one (r, c) from numpy on ``dev``."""
    rng = np.random.RandomState(seed)
    bufs = [torch.from_numpy(rng.randn(w, r, c).astype(np.float32)).to(dev)
            for _ in range(n)]
    xbar = torch.from_numpy(rng.randn(r, c).astype(np.float32)).to(dev)
    return bufs, xbar


def moderate_checks(chk, vu, tu, dev):
    """Phase 3 at the moderate and ragged shapes; returns the plain
    versions' times at the moderate shape (PR 11's two kernels)."""
    from repro_torch.optim import adam_scal

    plain_moderate = {}
    for seed, (w, r) in enumerate(MODERATE):
        (p, g, d, b, m, nu), xbar = numpy_inputs(seed, w, r, 256, dev, n=6)
        m.mul_(0.1)
        nu.square_().mul_(0.01)
        moments = {torch.float32: (m, nu),
                   torch.bfloat16: (m.bfloat16(), nu.bfloat16())}
        shape = f"W={w}, R={r}"
        for use_d in (False, True):
            for wd in (0.0, 1e-4):
                chk.run("fused_local_sgd", (p, g, d if use_d else None),
                        f"({shape}, d={use_d}, wd={wd})", lr=LR, wd=wd)
        for k_eff in (1, 2, 3):
            chk.run("fused_sync_vrl", (p, xbar, d, kg_scal(k_eff, dev)),
                    f"({shape}, k_eff={k_eff})")
        for corr in ("none", "d", "db"):
            dd = d if "d" in corr else None
            bb = b if "b" in corr else None
            for wd in (0.0, 1e-4):
                for mdt, (mm, nn) in moments.items():
                    tag = f"({shape}, {corr}, wd={wd}, {mdt}"
                    for nesterov in (False, True):
                        chk.run("fused_local_momentum", (p, g, dd, mm),
                                f"{tag}, nesterov={nesterov})", lr=LR,
                                beta=0.9, wd=wd, nesterov=nesterov, b=bb)
                    chk.run("fused_local_adam",
                            (p, g, dd, mm, nn, adam_scal(3, dev)),
                            f"{tag})", lr=1e-3, wd=wd, b=bb)
        sm3_checks(chk, p, g, d, b, m, nu, shape, dev)
        for beta in (0.5, 1.0):
            for k_eff in (1, 2, 3):
                chk.run("fused_sync_bvr",
                        (p, xbar, d, b, kg_scal(k_eff, dev)),
                        f"({shape}, beta={beta}, k_eff={k_eff})", beta=beta)
        center = p.mean(dim=0) + 0.25
        for alpha in (0.3, 0.9):
            chk.run("fused_sync_easgd", (p, xbar, center),
                    f"({shape}, alpha={alpha})", a=alpha / w,
                    na=w * (alpha / w))
        comm_checks(chk, p, g, d, b, xbar, shape)
        if (w, r) == MODERATE[0]:
            plain_moderate["fused_local_sgd"] = time_ms(
                lambda: tu.fused_local_sgd(p, g, d, lr=LR, wd=1e-4), 5)
            plain_moderate["fused_sync_vrl"] = time_ms(
                lambda: tu.fused_sync_vrl(p, xbar, d, kg_scal(2, dev)), 5)
        del p, g, d, b, m, nu, xbar, moments, center
        gc.collect()
        torch.cuda.empty_cache()
    return plain_moderate


def sm3_checks(chk, p, g, d, b, m, nu, shape, dev):
    """The flat SM3 Adam step: with and without Δ and B, wd 0 and 1e-4, fp32
    and bf16 mu, S ∈ {1, 2, 5} lane-stat spans (rows cut to a multiple of
    S), and rows with a planted NaN in g (compared NaN for NaN)."""
    from repro_torch.optim import adam_scal

    scal = adam_scal(3, dev)
    for shards in (1, 2, 5):
        r = p.shape[1] - p.shape[1] % shards
        pc, gs, dc, bc, mc = (x[:, :r].contiguous() for x in (p, g, d, b, m))
        row = nu[:, :r, :1].contiguous()
        col = nu[:, :shards].contiguous()
        for mdt in (torch.float32, torch.bfloat16):
            mm = mc.to(mdt)
            for corr in ("none", "d", "db"):
                for wd in (0.0, 1e-4):
                    chk.run("fused_local_adam_sm3",
                            (pc, gs, dc if "d" in corr else None, mm, row,
                             col, scal),
                            f"({shape}, rows {r}, S={shards}, {corr}, "
                            f"{mdt}, wd={wd})", lr=1e-3, wd=wd,
                            b=bc if "b" in corr else None)
        gn = gs.clone()
        gn[0, 3, 17] = float("nan")
        gn[-1, r - 1, 255] = float("nan")
        chk.run("fused_local_adam_sm3", (pc, gn, dc, mc, row, col, scal),
                f"({shape}, rows {r}, S={shards}, NaN in g)", nan=True,
                lr=1e-3, wd=1e-4, b=bc)
        del pc, gs, dc, bc, mc, row, col, gn


def hier_moderate_checks(chk, dev):
    """Phase 3 for the hierarchy's four kernels over (P, D, R, C) grids:
    (2, 3) and (3, 2) pods × workers, one worker per pod, one pod; the
    special rows in p; wd 0 and 1e-4, k_eff 1, 2, 3; the fold with and
    without capture and the miss mask all 0, all 1 and mixed."""
    for seed, (pp, dd, r) in enumerate(HIER_MODERATE):
        rng = np.random.RandomState(100 + seed)

        def arr(*shape):
            return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                    ).to(dev)
        p, g, d1 = (arr(pp, dd, r, 256) for _ in range(3))
        p = special_rows(p.view(-1, r, 256)).view(p.shape)
        d2, xpod, pend = (arr(pp, 1, r, 256) for _ in range(3))
        glob = arr(r, 256)
        shape = f"P={pp}, D={dd}, R={r}"
        for wd in (0.0, 1e-4):
            chk.run("fused_hier_local_sgd", (p, g, d1, d2),
                    f"({shape}, wd={wd})", lr=LR, wd=wd)
        for k_eff in (1, 2, 3):
            chk.run("fused_sync_hier1", (p, xpod, d1, kg_scal(k_eff, dev)),
                    f"({shape}, k_eff={k_eff})")
            chk.run("fused_sync_hier2", (p, glob, d2, kg_scal(k_eff, dev)),
                    f"({shape}, k_eff={k_eff})")
        for km in ((0,), (1,), (0, 1)):
            ws = wscal_for(pp, dev, (1, 2, 3), km)
            for capture in (False, True):
                chk.run("fused_fold_overlap_hier2", (p, glob, pend, d2, ws),
                        f"({shape}, km={km}, capture={capture})",
                        capture=capture)
        hier_inner_checks(chk, (p, g, d1, d2), arr(pp, dd, r, 256),
                          arr(pp, dd, r, 256), shape, dev)
        grid_ef_checks(chk, p, xpod, 0.01 * g, shape)
        del p, g, d1, d2, xpod, pend, glob
        free()


def grid_ef_checks(chk, p, ref, e, shape):
    """The grid EF round trips on one grid: int8 and top-k k ∈ {8, 64,
    256}, with and without the per-pod ref and the residual, on p's special
    rows; then once more with a NaN planted in one worker's row 5, compared
    NaN for NaN wherever it reaches an output (int8's whole row; top-k
    drops the NaN lane unless it keeps every lane, so only the residual
    holds it)."""
    pn = p.clone()
    pn[0, -1, 5, 7] = float("nan")
    for x, planted in ((p, False), (pn, True)):
        for use_ref in (False, True):
            for use_e in (False, True):
                args = (x, ref if use_ref else None, e if use_e else None)
                tag = (f"({shape}, ref={use_ref}, ef={use_e}"
                       + (", NaN row" if planted else ""))
                chk.run("fused_ef_int8_grid", args, tag + ")", nan=planted)
                for k in (8, 64, 256):
                    chk.run("fused_ef_topk_grid", args, f"{tag}, k={k})",
                            nan=planted and (use_e or k == 256), k=k)


def hier_inner_checks(chk, grid_bufs, a, b, shape, dev):
    """The hierarchy's momentum, Adam and SM3 Adam steps on one grid: fp32
    and bf16 moments, wd 0 and 1e-4, nesterov on and off, S ∈ {1, 2, 5}
    lane-stat spans (rows cut to a multiple of S), and for SM3 once more
    with a NaN planted in g (compared NaN for NaN)."""
    from repro_torch.optim import adam_scal

    p, g, d1, d2 = grid_bufs
    m, nu = 0.1 * a, 0.01 * b.square()
    scal = adam_scal(3, dev)
    for mdt in (torch.float32, torch.bfloat16):
        mm, nn = m.to(mdt), nu.to(mdt)
        for wd in (0.0, 1e-4):
            tag = f"({shape}, {mdt}, wd={wd}"
            for nesterov in (False, True):
                chk.run("fused_hier_local_momentum", (p, g, d1, d2, mm),
                        f"{tag}, nesterov={nesterov})",
                        lr=HIER_MOMENTUM_LR, beta=0.9, wd=wd,
                        nesterov=nesterov)
            chk.run("fused_hier_local_adam", (p, g, d1, d2, mm, nn, scal),
                    tag + ")", lr=1e-3, wd=wd)
        for shards in (1, 2, 5):
            r = p.shape[2] - p.shape[2] % shards
            cut = [x[:, :, :r].contiguous() for x in (p, g, d1, d2, mm)]
            row = nu[:, :, :r, :1].contiguous()
            col = nu[:, :, :shards].contiguous()
            for wd in (0.0, 1e-4):
                chk.run("fused_hier_local_adam_sm3", (*cut, row, col, scal),
                        f"({shape}, rows {r}, S={shards}, {mdt}, wd={wd})",
                        lr=1e-3, wd=wd)
            cut[1] = cut[1].clone()
            cut[1][0, -1, 1, 5] = float("nan")
            chk.run("fused_hier_local_adam_sm3", (*cut, row, col, scal),
                    f"({shape}, rows {r}, S={shards}, {mdt}, NaN in g)",
                    nan=True, lr=1e-3, wd=1e-4)
            del cut, row, col


def special_rows(p: torch.Tensor) -> torch.Tensor:
    """Rows 0-3 of every worker set to the round trip's hard cases: ± ties
    at the top magnitudes, all zeros, fewer non-zeros than the smallest k
    (8), and ±1 at int8 scale 2 (every x/safe an exact .5)."""
    x = p.clone()
    x[:, 0] *= 0.1
    x[:, 0, :6] = torch.tensor([3.0, -3.0, 3.0, -2.5, 2.5, 2.5])
    x[:, 1:3] = 0.0
    x[:, 2, :4] = torch.linspace(0.5, 1.0, 4)
    x[:, 3] = torch.where(torch.arange(x.shape[-1], device=x.device) % 2
                          == 1, 1.0, -1.0)
    x[:, 3, 0] = 254.0
    return x


def wscal_for(w, dev, pend_k, km):
    """The folds' (W, 2) [1/(pend_k γ), km], made as the engine makes it."""
    pk = torch.tensor([pend_k[i % len(pend_k)] for i in range(w)],
                      dtype=torch.float32, device=dev)
    kmt = torch.tensor([km[i % len(km)] for i in range(w)],
                       dtype=torch.float32, device=dev)
    inv = torch.reciprocal(pk * LR)
    return torch.stack([inv, kmt], dim=1).contiguous()


def comm_checks(chk, p, g, d, b, xbar, shape):
    """The EF round trip and the overlap fold over their variants."""
    dev = p.device
    x = special_rows(p)
    e = 0.01 * g
    for use_ref in (False, True):
        for use_e in (False, True):
            args = (x, xbar if use_ref else None, e if use_e else None)
            tag = f"({shape}, ref={use_ref}, ef={use_e}"
            chk.run("fused_ef_int8", args, tag + ")")
            for k in (8, 64, 256):
                chk.run("fused_ef_topk", args, f"{tag}, k={k})", k=k)
    pend = p + 0.1 * g
    for pend_k, km in (((1, 2, 3), (0, 1)), ((3,), (0,))):
        ws = wscal_for(p.shape[0], dev, pend_k, km)
        for capture in (False, True):
            tag = f"({shape}, pend_k={pend_k}, km={km}, capture={capture}"
            chk.run("fused_fold_overlap", (p, xbar, pend, d, ws), tag + ")",
                    capture=capture)
            chk.run("fused_fold_overlap_avg", (p, xbar, pend, ws),
                    tag + ")", capture=capture)
            for beta in (0.5, 1.0):
                chk.run("fused_fold_overlap_bvr", (p, xbar, pend, d, b, ws),
                        f"{tag}, beta={beta})", beta=beta,
                        capture=capture)


def amax(x: torch.Tensor) -> float:
    """max|x|, read without an |x| temporary the size of ``x``."""
    return torch.linalg.vector_norm(x, float("inf")).item()


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def full_shape(chk, vu, tu, dev):
    """Phase 3 at the full shape with the main paths' operands, one rule
    for every kernel: bitwise worker slice by worker slice, then the
    kernel's time in place on the whole buffer and the plain version's
    slice by slice.  Returns {kernel: ms}, {kernel: plain ms} and
    {kernel: library ms or None}."""
    from repro_torch.optim import adam_scal

    w = FULL[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    times, plain = {}, {}
    library = {name: None for name in KERNELS}

    def randn(shape=FULL):
        return torch.randn(shape, generator=gen, device=dev)

    def measure(name, args, ndim=3, per_worker=False, **kw):
        chk.full_shape(name, args, ndim=ndim, per_worker=per_worker, **kw)
        times[name] = time_ms(lambda: getattr(vu, name)(*args, **kw), 10,
                              warmup=2)
        fn = getattr(tu, name)
        slices = [worker_slice(i, args, kw, ndim, per_worker)
                  for i in range(slice_count(args, ndim, per_worker))]

        def run():
            for sl_args, sl_kw in slices:
                fn(*sl_args, **sl_kw)
        plain[name] = time_ms(run, 1)
        del slices
        free()

    # vrl_sgd's path: sgd with Δ, wd 1e-4
    p, g, d = randn(), randn(), randn()
    measure("fused_local_sgd", (p, g, d), lr=LR, wd=1e-4)
    library["fused_local_sgd"] = optimizer_library(
        "fused_local_sgd",
        lambda p0, g0: tu.fused_local_sgd(p0, g0, None, lr=LR, wd=1e-4),
        p, g, lr=LR, wd=1e-4)
    # easgd's path: momentum without Δ or B, fp32 m, wd 1e-4
    m = randn().mul_(0.1)
    measure("fused_local_momentum", (p, g, None, m), lr=LR, beta=0.9,
            wd=1e-4)
    library["fused_local_momentum"] = optimizer_library(
        "fused_local_momentum",
        lambda p0, g0, m0: tu.fused_local_momentum(p0, g0, None, m0, lr=LR,
                                                   beta=0.9, wd=1e-4),
        p, g, (m,), lr=LR, wd=1e-4, beta=0.9)
    del m
    # bvr_l_sgd's path: adam with Δ and B, fp32 mu and nu
    b, mu, nu = randn(), randn().mul_(0.1), randn()
    nu.square_().mul_(0.01)
    measure("fused_local_adam", (p, g, d, mu, nu, adam_scal(3, dev)),
            lr=1e-3, wd=1e-4, b=b)
    library["fused_local_adam"] = optimizer_library(
        "fused_local_adam",
        lambda p0, g0, mu0, nu0: tu.fused_local_adam(
            p0, g0, None, mu0, nu0, adam_scal(3, dev), lr=1e-3, wd=1e-4),
        p, g, (mu, nu), lr=1e-3, wd=1e-4)
    del g, mu, nu
    free()
    # each sync from fresh, unsynced workers (a timed sync leaves p = x̂)
    p.normal_(generator=gen)
    xbar = p.mean(dim=0)
    measure("fused_sync_vrl", (p, xbar, d, kg_scal(2, dev)))
    p.normal_(generator=gen)
    xbar = p.mean(dim=0)
    measure("fused_sync_bvr", (p, xbar, d, b, kg_scal(2, dev)), beta=0.5)
    del d, b
    free()
    p.normal_(generator=gen)
    xbar = p.mean(dim=0)
    center = randn(FULL[1:])
    measure("fused_sync_easgd", (p, xbar, center), a=0.3 / w,
            na=w * (0.3 / w))
    del center
    free()
    # path (c)'s round trip: int8 with ref and EF; path (d)'s: top-k:32
    # with the stale mean as ref and EF
    p.normal_(generator=gen)
    e, ref = randn().mul_(0.01), randn(FULL[1:])
    measure("fused_ef_int8", (p, ref, e))
    measure("fused_ef_topk", (p, ref, e), k=TOPK_FULL)
    library["fused_ef_topk"] = topk_library(p, ref, e, TOPK_FULL)
    del e, ref
    free()
    # the folds with their paths' operands: (e) capture, (d) bvr without
    # capture, (f) avg with capture; pend_k = 2 and no misses, as there
    pend, d, b = randn(), randn(), randn()
    ws = wscal_for(w, dev, (2,), (0,))
    measure("fused_fold_overlap", (p, xbar, pend, d, ws), capture=True)
    measure("fused_fold_overlap_bvr", (p, xbar, pend, d, b, ws), beta=0.5,
            capture=False)
    measure("fused_fold_overlap_avg", (p, xbar, pend, ws), capture=True)
    del p, xbar, pend, d, b, ws
    free()
    # the hierarchy's kernels with paths (g) and (h)'s operands, at (P, D)
    # = (2, 2): bitwise pod by pod, the plain versions timed pod by pod
    pod = HIER_FULL[:1] + (1,) + HIER_FULL[2:]
    p, g, d1, d2 = randn(HIER_FULL), randn(HIER_FULL), randn(HIER_FULL), \
        randn(pod)
    measure("fused_hier_local_sgd", (p, g, d1, d2), ndim=4, lr=LR, wd=1e-4)
    zero = torch.zeros(HIER_FULL[2:], device=dev)     # Δ1 = Δ2 = 0
    library["fused_hier_local_sgd"] = optimizer_library(
        "fused_hier_local_sgd",
        lambda p0, g0: tu.fused_hier_local_sgd(p0, g0, zero, zero, lr=LR,
                                               wd=1e-4),
        p, g, lr=LR, wd=1e-4, lead=2)
    del g, zero
    free()
    p.normal_(generator=gen)
    xpod = p.mean(dim=1, keepdim=True)
    measure("fused_sync_hier1", (p, xpod, d1, kg_scal(2, dev)), ndim=4)
    del xpod, d1
    free()
    p.normal_(generator=gen)
    glob = p[:, :1].mean(dim=(0, 1))
    measure("fused_sync_hier2", (p, glob, d2, kg_scal(4, dev)), ndim=4)
    # (h)'s fold: capture, pend_k = 4 (k2), no misses
    p.normal_(generator=gen)
    pend = randn(pod)
    measure("fused_fold_overlap_hier2",
            (p, glob, pend, d2, wscal_for(HIER_FULL[0], dev, (4,), (0,))),
            ndim=4, capture=True)
    del p, d2, glob, pend
    free()
    # paths (m)-(o)'s level-1 round trips: the per-pod ref and the residual,
    # checked and the plain version timed pod by pod; then level 2's flat
    # round trip over the strided pod rows
    p, e, ref = randn(HIER_FULL), randn(HIER_FULL).mul_(0.01), randn(pod)
    measure("fused_ef_int8_grid", (p, ref, e), ndim=4)
    measure("fused_ef_topk_grid", (p, ref, e), ndim=4, k=TOPK_FULL)
    library["fused_ef_topk_grid"] = topk_library(p, ref, e, TOPK_FULL,
                                                 "fused_ef_topk_grid")
    del ref, e
    free()
    level2_strided(chk, vu, p, randn(pod).mul_(0.01)[:, 0],
                   randn(HIER_FULL[2:]))
    del p
    free()
    # path (i)'s SM3 Adam: Δ, fp32 mu, one lane-stat span, wd 1e-4
    p, g, d, mu = randn(), randn(), randn(), randn().mul_(0.1)
    row = randn(FULL[:2] + (1,)).square_().mul_(0.01)
    col = randn((w, 1, FULL[2])).square_().mul_(0.01)
    measure("fused_local_adam_sm3", (p, g, d, mu, row, col,
                                     adam_scal(3, dev)), lr=1e-3, wd=1e-4)
    del p, g, d, mu, row, col
    free()
    # paths (j)-(l): the hierarchy's local steps at (P, D) = (2, 2), checked
    # and their plain versions timed worker by worker (they read nothing
    # across a pod but Δ2)
    p, g, d1, d2 = randn(HIER_FULL), randn(HIER_FULL), randn(HIER_FULL), \
        randn(pod)
    m = randn(HIER_FULL).mul_(0.1)
    measure("fused_hier_local_momentum", (p, g, d1, d2, m), ndim=4,
            per_worker=True, lr=HIER_MOMENTUM_LR, beta=0.9, wd=1e-4)
    zero = torch.zeros(HIER_FULL[2:], device=dev)     # Δ1 = Δ2 = 0
    library["fused_hier_local_momentum"] = optimizer_library(
        "fused_hier_local_momentum",
        lambda p0, g0, m0: tu.fused_hier_local_momentum(
            p0, g0, zero, zero, m0, lr=HIER_MOMENTUM_LR, beta=0.9, wd=1e-4),
        p, g, (m,), lr=HIER_MOMENTUM_LR, wd=1e-4, beta=0.9, lead=2)
    nu = randn(HIER_FULL).square_().mul_(0.01)
    measure("fused_hier_local_adam", (p, g, d1, d2, m, nu, adam_scal(3, dev)),
            ndim=4, per_worker=True, lr=1e-3, wd=1e-4)
    library["fused_hier_local_adam"] = optimizer_library(
        "fused_hier_local_adam",
        lambda p0, g0, mu0, nu0: tu.fused_hier_local_adam(
            p0, g0, zero, zero, mu0, nu0, adam_scal(3, dev), lr=1e-3,
            wd=1e-4),
        p, g, (m, nu), lr=1e-3, wd=1e-4, lead=2)
    del nu, zero
    free()
    mu = m.bfloat16()
    del m
    row = randn(HIER_FULL[:3] + (1,)).square_().mul_(0.01)
    col = randn(HIER_FULL[:2] + (1, HIER_FULL[3])).square_().mul_(0.01)
    measure("fused_hier_local_adam_sm3",
            (p, g, d1, d2, mu, row, col, adam_scal(3, dev)), ndim=4,
            per_worker=True, lr=1e-3, wd=1e-4)
    del p, g, d1, d2, mu, row, col
    free()
    return times, plain, library


def topk_library(p, ref, e, k, name="fused_ef_topk") -> float:
    """The partial yardstick of ``fused_ef_topk`` (``name``: the grid form,
    ref per pod): ``torch.topk`` of the payload's magnitudes over each row
    (the selection alone, without the payload, the threshold keep or the
    residual); the port never calls it."""
    a = ((p - ref) + e).abs_()
    t = time_ms(lambda: torch.topk(a, k, dim=-1), 10, warmup=2)
    del a
    free()
    print(f"[3 kernels] library for {name} (partial: selection "
          f"only): torch.topk(|payload|, {k}, dim=-1) {t:.3f} ms",
          flush=True)
    return t


def level2_strided(chk, vu, p, e2, ref2):
    """Level 2's flat round trips at full width on the pod rows p[:, 0] of
    the (P, D, R, C) buffer, a strided (P, R, C) view (no copy), with the
    global ref and the contiguous resid2[:, 0]: bitwise the plain version
    on the view (pod by pod), then timed in place beside their bound —
    read the P pod rows, e2 and ref, write dec and e2: (4 P + 1) R·C
    buffers.  Printed; the kernels' rows stay the flat shape's."""
    pod = p[:, 0]
    pp, r, c = pod.shape
    for name, kw in (("fused_ef_int8", {}), ("fused_ef_topk",
                                               {"k": TOPK_FULL})):
        chk.full_shape(name, (pod, ref2, e2), **kw)
        t = time_ms(lambda: getattr(vu, name)(pod, ref2, e2, **kw), 10,
                    warmup=2)
        b, _ = bound_ms(4 * (4 * pp * r * c + r * c),
                        (10 if name == "fused_ef_int8" else 37) * pp * r * c)
        print(f"[3 kernels] {name} on the strided pod rows p[:, 0] of "
              f"{tuple(p.shape)} (level 2): {t:.3f} ms (bound {b:.3f} ms, "
              f"{100 * b / t:.1f}%), bitwise the plain version", flush=True)
        free()


def optimizer_library(name, plain, p, g, states=(), *, lr, wd, beta=0.0,
                      lead=1) -> float:
    """The library time of an update kernel on its path's operands without
    Δ (or B): ``torch._fused_sgd_``, the kernel of ``torch.optim.SGD(
    momentum=β, weight_decay=wd, fused=True)`` — v = g + wd·p; m' = βm + v;
    p' = p − γm', and p' = p − γ(g + wd·p) at momentum 0 with no buffer —
    for the sgd and momentum kernels (``states`` = (m,) or ()), and
    ``torch._fused_adamw_`` — p(1 − γ·wd) − γ(m'/c1)/(√ν'/√c2 + ε) at
    step t = 3 — for the Adam kernels (``states`` = (mu, nu), fp32).  Each
    is held to ``plain`` (the kernel's plain version with Δ absent or zero,
    called on worker 0's clones, returning p' and the states) at rtol 1e-5
    (it may contract the products into FMAs and round in another order),
    then timed over the worker slices (the first ``lead`` axes) in one
    call; the port never calls it.  Both update p and the states in place,
    as the kernels' timed calls do."""
    adam = len(states) == 2
    steps = [torch.full((), 3.0, device=p.device)]

    def call(ps, gs, ss):
        if adam:
            torch._fused_adamw_(ps, gs, ss[0], ss[1], [], steps * len(ps),
                                lr=lr, beta1=0.9, beta2=0.999,
                                weight_decay=wd, eps=1e-8, amsgrad=False,
                                maximize=False)
        else:
            torch._fused_sgd_(ps, gs, ss[0] if ss else [], weight_decay=wd,
                              momentum=beta, lr=lr, dampening=0.0,
                              nesterov=False, maximize=False,
                              is_first_step=False)

    first = (0,) * lead
    p0, g0 = p[first].clone(), g[first].clone()
    s0 = [t[first].clone() for t in states]
    want = plain(p0.clone(), g0, *(t.clone() for t in s0))
    want = want if isinstance(want, tuple) else (want,)
    call([p0], [g0], [[t] for t in s0])
    got = (p0, *s0)
    for x, ref in zip(got, want):
        torch.testing.assert_close(x, ref, rtol=1e-5, atol=1e-6)
    err = max((x - ref).abs().max().item() for x, ref in zip(got, want))
    del p0, g0, s0, want, got
    free()
    ps, gs = (list(t.flatten(0, lead - 1).unbind(0)) for t in (p, g))
    ss = [list(t.flatten(0, lead - 1).unbind(0)) for t in states]
    t = time_ms(lambda: call(ps, gs, ss), 10, warmup=2)
    lib = "torch._fused_adamw_" if adam else "torch._fused_sgd_"
    print(f"[3 kernels] library for {name} (without Δ): {lib} {t:.3f} ms "
          f"over the {len(ps)} worker slices; max abs diff from the plain "
          f"version on worker 0: {err}", flush=True)
    return t


def sync_periods(args) -> list:
    """The k_eff of each sync of a flat CLI run on the constant schedule,
    as ``launch.train`` walks it: ``--warmup``'s 1-step first round, then
    rounds of ``--k``."""
    rest = args.steps - args.warmup
    if args.comm_schedule or rest % args.k:
        raise ValueError("only whole rounds of --k after the warm-up round")
    return [1] * args.warmup + [args.k] * (rest // args.k)


def cli_path(tag, argv, want_launches, launch, vu, grid=None,
             misses=None, rounding=False, phase="4 main path"):
    """A full-width path through ``repro_torch.launch.train``: launch
    counts, finite logged losses, the flat layout, and Σ_i Δ_i after the
    last sync (or fold) against the largest |Δ| the run logged (its first
    sync's, here: the fp32 rounding residue of each sync stays in Σ Δ after
    Δ itself shrinks).  ``grid``: hier_vrl_sgd's (P, D); then Σ_d Δ1 within
    every pod and Σ_p Δ2 instead (``hier_sums``), and ``misses``: the
    (step, per-pod mask, pend_k) the CLI logs at each deadline fold.  The
    peak is the CLI's, over its rounds alone; the flat layout expected is
    the reference's for the ``--arch`` and ``--layers`` in ``argv``
    (``expected_layout``).  ``rounding``: where Δ
    is O(1), the fp32 rounding of x̂ that each sync keeps, 2 W ulp(max|p|)
    /(k_eff γ), is no longer negligible beside 1e-4 · max|Δ| (as for Adam's
    paths: ``check_sums``), so the bound adds it over the run's syncs
    (``sync_periods``); max|p| is the largest the CLI logged."""
    from repro_torch.configs import registry
    args = launch.parse_args(argv)
    layout = expected_layout(args)
    vu.reset_launches()
    res = launch.run(argv)
    launches = dict(vu.LAUNCHES)
    check_launches(tag, launches, want_launches)
    logged = res.losses + res.avg_model_losses
    if not all(math.isfinite(x) for x in logged):
        raise AssertionError(f"path {tag}: non-finite loss {logged}")
    if res.engine is None:
        # the per-leaf executor: the tree's elements per worker
        n = sum(x.numel() for x in tm_leaves(res.state.params))
        if n != args.workers * layout[0]:
            raise AssertionError(f"path {tag}: the tree holds {n} elements")
    elif (res.engine.spec.size, res.engine.spec.rows,
          res.engine.spec.lanes) != layout:
        raise AssertionError(f"unexpected flat layout "
                             f"{res.engine.spec.meta()}")
    if grid is not None:
        note = "; " + hier_sums(tag, res, grid)
        if misses is not None:
            got = [(t, m, k) for t, m, k in res.misses]
            if got != misses:
                raise AssertionError(f"path {tag}: per-pod misses and "
                                     f"pend_k {got}, expected {misses}")
            note += (f"; per-pod misses (step, mask, pend_k after) {got}, "
                     f"the reference's draws")
    else:
        _, sum_d, _ = res.invariant[-1]
        max_d = max(m for _, _, m in res.invariant)
        x_hat = 0.0
        if rounding:
            ulp = float(np.spacing(np.float32(max(
                m for _, m in res.param_max))))
            x_hat = sum(2 * args.workers * ulp / (k * args.lr)
                        for k in sync_periods(args))
        if not (max_d > 0 and sum_d <= 1e-4 * max_d + x_hat):
            raise AssertionError(
                f"path {tag}: Σ_i Δ_i not ~0 after the last sync: max|ΣΔ| "
                f"{sum_d} vs max|Δ| {max_d} (x̂ rounding {x_hat})")
        note = f"; max|ΣΔ| {sum_d:.3e} <= 1e-4 * max|Δ| {max_d:.3e}" + (
            f" + x̂ rounding {x_hat:.3e}" if rounding else "")
    out = path_result(tag, res.losses, res.wall_s, res.phases_ms, launches,
                      args.lr, w=args.workers, peak=res.round_peak_bytes,
                      arch=args.arch, avg=res.avg_model_losses,
                      layers=args.layers or registry.get_arch(
                          args.arch).num_layers)
    print_path(out, f"; avg-model "
               f"{['%.4f' % x for x in res.avg_model_losses]}" + note,
               phase=phase)
    if grid is not None:
        print(f"[{phase} {tag}] device ms per round: "
              + ", ".join(f"{k} {['%.3f' % x for x in v]}"
                          for k, v in res.phases_ms.items()
                          if k != "fwd_bwd"), flush=True)
    del res
    free()
    return out


def tm_leaves(tree):
    from repro_torch import tree as tm
    return tm.leaves(tree)


def hier_sums(tag, res, grid, lr=MAIN_LR) -> str:
    """Paths (g), (h), (m)-(o), (z3), (z4) through the CLI's log: a level
    whose syncs move its Δ sum by a known term (``TrainResult.
    level_terms``: the EF term under blocking compression, the deadline
    fold's) is held to that move at every logged round; the others to
    ``hier_limits``."""
    moved = {r["level"] for r in res.level_terms}
    notes = []
    for level in sorted(moved):
        recs = [r for r in res.level_terms if r["level"] == level]
        worst = max(recs, key=lambda r: r["off"] / r["limit"])
        if worst["off"] > worst["limit"]:
            raise AssertionError(f"path {tag}: Σ {level} moved "
                                 f"{worst['off']} away from its "
                                 f"{worst['kind']} term at step "
                                 f"{worst['step']} (limit {worst['limit']})")
        # some EF term must stand clear of the limit, so that a sync which
        # lost it would fail (at full width 1e-4 · max|Δ2| is large: Δ
        # reaches ~1e10 at γ = 1e-3)
        efs = [r for r in recs if r["kind"] == "ef"]
        if efs and not any(r["term"] > 2 * r["limit"] for r in efs):
            raise AssertionError(f"path {tag}: the EF term of {level} never "
                                 f"stands above twice the limit: {efs}")
        kinds = "/".join(sorted({r["kind"] for r in recs}))
        notes.append(f"Σ {level} moved by its {kinds} term (largest "
                     f"{max(r['term'] for r in recs):.3e}) at each of "
                     f"{len(recs)} rounds to within {worst['off']:.3e} <= "
                     f"{worst['limit']:.3e}")
    log1 = [(s, m) for _, s, m in res.invariant]
    log2 = [(s, m) for _, s, m in res.bias_invariant]
    max_ps = [mp for _, mp in res.param_max]
    if moved != {"delta1", "delta2"}:
        notes.append(hier_limits(tag, None if "delta1" in moved else log1,
                                 None if "delta2" in moved else log2,
                                 max_ps, grid, lr))
    return "; ".join(notes)


def hier_limits(tag, log1, log2, max_ps, grid, lr) -> str:
    """After the last round, max_p max|Σ_d Δ1[p, d]| and max|Σ_p Δ2[p]|
    (the last of ``log1``, ``log2``: (max|Σ|, max|Δ|) per round) within
    1e-4 · the largest |Δ1| (|Δ2|) the run logged plus the fp32 rounding
    of the means the syncs keep: 2 n ulp(max|p|)/(k1 γ) per round (n = D
    for Δ1, P for Δ2; k1 γ is the smallest divisor any sync or fold of this
    run uses, so the bound is generous for Δ2)."""
    pods, dper = grid
    notes = []
    for name, log, n in (("Δ1 (per pod)", log1, dper), ("Δ2", log2, pods)):
        if log is None:             # held to its move instead
            continue
        rounding = sum(2 * n * float(np.spacing(np.float32(mp)))
                       / (HIER_K1 * lr) for mp in max_ps)
        sum_b = log[-1][0]
        max_b = max(m for _, m in log)
        limit = 1e-4 * max_b + rounding
        if not (max_b > 0 and sum_b <= limit):
            raise AssertionError(f"path {tag}: Σ {name} not ~0 after the "
                                 f"last round: {sum_b} > {limit}")
        notes.append(f"max|Σ {name}| {sum_b:.3e} <= {limit:.3e} (1e-4 * "
                     f"max|{name.split()[0]}| {max_b:.3e} + rounding "
                     f"{rounding:.3e})")
    return "; ".join(notes)


def check_launches(tag, launches, want_launches):
    want = {k: 0 for k in launches}
    want.update(want_launches)
    if launches != want:
        raise AssertionError(f"path {tag}: launches {launches}, expected "
                             f"{want}")


def path_result(tag, losses, wall_s, phases, launches, lr, w=4, peak=None,
                **extra):
    """What print_path reads from one full-width path; ``peak``: bytes
    allocated at most (default: since the last reset of the peak)."""
    peak = torch.cuda.max_memory_allocated() if peak is None else peak
    return dict(tag=tag, losses=losses, wall_ms=1e3 * wall_s / len(losses),
                steady={k: float(np.mean(v[1:])) for k, v in phases.items()},
                peak_gib=peak / 2 ** 30,
                launches={k: v for k, v in launches.items() if v}, lr=lr,
                w=w, **extra)


def easgd_sync_check(chk, tu):
    """For path (b): one more easgd sync through the engine on the path's
    final state (after its counts are read), held bitwise against the
    plain version on worker 0's slice and the center, with the engine's
    x̂ (the fp32 worker mean of the pre-sync parameters)."""
    def check(bundle, state, vrl):
        p = state.params
        n = p.shape[0]
        a = vrl.easgd_alpha / n
        xbar = p.to(torch.float32).mean(dim=0)
        want = tu.fused_sync_easgd(p[:1], xbar, state.center, a=a, na=n * a)
        del xbar
        state = bundle.sync_step(state)
        torch.cuda.synchronize()
        chk.compare("fused_sync_easgd", (state.params[:1], state.center),
                    want, "path (b) final state, through the engine")
        return ("; one more sync through the engine on the final state: "
                "worker 0 and the center bitwise the plain version")
    return check


def ef_identity_watch(state):
    """Path (c), before a round: Σ_i Δ_i, Σ_i e_i, max|Δ| and max|p|;
    returns what reads the round's sync after it: how far Σ_i Δ_i's move
    stands from Σ_i (e_i − e'_i)/(k_eff γ) (x̂ − mean_i p_i = mean_i(e_i −
    e'_i)), against the fp32 rounding of the sync: 1e-4 · the larger
    max|Δ| before or after it (Δ + u rounds at the scale of both) plus 2 W
    ulp(max|p|)/(k_eff γ) (x̂ rounded once more)."""
    # the two (R, C) sums wait on the host, outside the round's peak memory
    sum_d0 = state.delta.sum(dim=0).cpu()
    sum_e0 = state.comm.resid.sum(dim=0).cpu()
    max_p0 = state.params.abs().max().item()
    max_d0 = state.delta.abs().max().item()

    def after(state, rk):
        dev = state.delta.device
        term = ((sum_e0.to(dev) - state.comm.resid.sum(dim=0))
                / (rk * MAIN_LR))
        moved = state.delta.sum(dim=0) - sum_d0.to(dev)
        off = (moved - term).abs().max().item()
        max_p = max(max_p0, state.params.abs().max().item())
        max_d = max(max_d0, state.delta.abs().max().item())
        w = state.params.shape[0]
        limit = (1e-4 * max_d + 2 * w * float(np.spacing(np.float32(max_p)))
                 / (rk * MAIN_LR))
        if not off <= limit:
            raise AssertionError(f"path (c): Σ_i Δ_i moved {off} away from "
                                 f"the EF term (limit {limit})")
        return {"ef_term": term.abs().max().item(), "off": off,
                "limit": limit}
    return after


def train_path(tag, vrl_kw, rounds, want_launches, dev, vu,
               require_finite=True, after=None, watch=None, cfg=None,
               batch=8, seq=64, make_kw=None, w=4, start=None):
    """One full-width path through ``make_train_step(timed=True)`` and
    ``round_step``, W=4, on the synthetic non-iid stream: qwen2-0.5b at
    phase 4's cut depth, batch 8, seq 64 unless ``cfg``, ``batch``,
    ``seq``, ``w`` say otherwise;
    ``make_kw``: more ``make_train_step`` arguments (remat, chunked_ce).
    The launch counters are zeroed just before the rounds and read just
    after.  ``watch(state)``, before each round and outside its timing,
    returns a check ``(state, k) -> record`` of the round's sync.
    ``after(bundle, state, vrl)`` then checks the final state and returns
    a note.  ``start(bundle, w)`` makes the first state (default
    ``bundle.init_state(0, w)``).  Returns what was measured."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import VRLConfig
    from repro_torch.core import engine as engine_mod
    from repro_torch.data import assigned_token_stream, contiguous_assignment
    from repro_torch.train.train_loop import make_train_step

    cfg = qwen_cut() if cfg is None else cfg
    steps = sum(rounds)
    vrl = VRLConfig(**vrl_kw)
    bundle = make_train_step(cfg, vrl, device=dev, timed=True,
                             **(make_kw or {}))
    state = (bundle.init_state(0, w) if start is None
             else start(bundle, w))
    data = assigned_token_stream(contiguous_assignment(w, w), seq,
                                 cfg.vocab_size, steps=steps, batch=batch,
                                 alpha=0.05, seed=0)
    vu.reset_launches()
    losses, wall, inv, t, watched, peak = [], 0.0, [], 0, [], 0
    for rk in rounds:
        toks = torch.from_numpy(data[t:t + rk]).to(dev, torch.long)
        check = watch(state) if watch is not None else None
        ov = state.overlap
        # under overlap the round's fold averages pend over pend_k steps
        before = ((amax(ov.pend), ov.pend_k.max().item())
                  if ov != () else (0.0, rk))
        # the peak of the rounds alone: the checks between them make
        # (W, R, C) temporaries of their own
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, lk = bundle.round_step(state, toks,
                                      torch.roll(toks, -1, dims=-1))
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        peak = max(peak, torch.cuda.max_memory_allocated())
        t += rk
        losses += lk.tolist()
        # outside the timed round: Σ_i Δ_i, Σ_i B_i (hier: Σ_d Δ1 in every
        # pod, Σ_p Δ2) and max|p| after it
        bufs = ((("delta1", state.delta1, 1), ("delta2", state.delta2, 0))
                if hasattr(state, "delta1") else
                (("delta", state.delta, 0), ("bias", state.bias, 0)))
        inv.append({name: engine_mod.sum_invariant(buf, dim=dim)
                    for name, buf, dim in bufs
                    if isinstance(buf, torch.Tensor)})
        inv[-1]["max_p"] = max(amax(state.params), before[0])
        inv[-1]["k"] = before[1]
        if check is not None:
            watched.append(check(state, rk))
    launches = dict(vu.LAUNCHES)
    check_launches(tag, launches, want_launches)
    finite = all(math.isfinite(x) for x in losses)
    if require_finite and not finite:
        raise AssertionError(f"path {tag}: non-finite loss {losses}")
    phases = bundle.timer.ms()
    out = path_result(tag, losses, wall, phases, launches,
                      vrl.learning_rate, w, peak=peak, inv=inv,
                      finite=finite, watched=watched, rounds_ms=phases,
                      arch=cfg.name, layers=cfg.num_layers)
    out["note"] = after(bundle, state, vrl) if after is not None else ""
    del bundle, state
    free()
    return out


def check_sums(res) -> str:
    """Σ_i Δ_i and Σ_i B_i after the last sync: within 1e-4 · the run's
    largest |Δ| (|B|) plus the fp32 rounding of x̂ the syncs keep.  The
    fp32 mean of W values is within 2 ulp(max|p|) of the exact mean (the
    sum's roundings and the division's), and Σ_i (x̂ − p_i)/(k_eff γ)
    keeps W times that: 2 W ulp(max|p|)/(k_eff γ), summed over the
    syncs (under overlap: the fold's Σ_i (x̂_stale − pend_i)/(pend_k γ),
    with max|pend| and pend_k)."""
    rounding = sum(2 * res["w"] * float(np.spacing(np.float32(r["max_p"])))
                   / (r["k"] * res["lr"]) for r in res["inv"])
    notes = []
    for name in ("delta", "bias"):
        if name not in res["inv"][-1]:
            continue
        sum_b = res["inv"][-1][name][0]
        max_b = max(r[name][1] for r in res["inv"])
        limit = 1e-4 * max_b + rounding
        if not (max_b > 0 and sum_b <= limit):
            raise AssertionError(f"path {res['tag']}: Σ_i {name}_i not ~0 "
                                 f"after the last sync: {sum_b} > {limit}")
        notes.append(f"max|Σ{name}| {sum_b:.3e} <= {limit:.3e} (1e-4 * "
                     f"max|{name}| {max_b:.3e} + x̂ rounding "
                     f"{rounding:.3e})")
    return "; ".join(notes)


def check_hier_sums(res, grid=(2, 2)) -> str:
    """Paths (j)-(l): ``hier_limits`` over the rounds' records."""
    inv = res["inv"]
    return hier_limits(res["tag"], [r["delta1"] for r in inv],
                       [r["delta2"] for r in inv], [r["max_p"] for r in inv],
                       grid, res["lr"])


def print_rounds(res) -> None:
    """The device ms of every round's spans but fwd/bwd (the hierarchy's
    sync span holds sync2 every other round)."""
    print(f"[4 main path {res['tag']}] device ms per round: "
          + ", ".join(f"{k} {['%.3f' % x for x in v]}"
                      for k, v in res["rounds_ms"].items()
                      if k != "fwd_bwd"),
          flush=True)


def sm3_note(bundle, state, vrl) -> str:
    """The SM3 stats' bytes against the dense nu they replace (computed
    from the state's shapes)."""
    nu = state.inner.nu
    stats = sum(x.numel() * x.element_size() for x in nu)
    dense = state.params.numel() * 4
    return (f"; SM3 stats row {tuple(nu.row.shape)} + lane "
            f"{tuple(nu.col.shape)} = {stats / 2**20:.2f} MiB in place of a "
            f"dense fp32 nu of {dense / 2**30:.2f} GiB; mu "
            f"{state.inner.mu.dtype}")


SPAN_NAMES = {"fwd_bwd": "fwd/bwd (4 workers) {:.2f}/step",
              "local": "local update {:.3f}/step",
              "sync": "worker mean + sync {:.3f}/round",
              "round_begin": "round_begin (mean over pend) {:.3f}/round",
              "fold": "fold + capture {:.3f}/round"}


def wire_note(vrl_kw, layout=None) -> str:
    """The compressed path's sync wire bytes per worker against the raw
    flat buffer (``comm.compressors.wire_bytes``: computed from the
    layout (size, rows, lanes), phase 4's cut one by default; one card has
    no wire to measure)."""
    from repro_torch.comm import compressors as comm_mod
    size, rows, lanes = layout or QWEN_CUT_LAYOUTS[CUT_LAYERS]
    raw = comm_mod.raw_bytes(rows, lanes)
    wire = comm_mod.wire_bytes(vrl_kw["compress"], rows=rows, lanes=lanes,
                               size=size)
    return (f"; sync wire {wire / 2**20:.2f} MiB per worker vs raw "
            f"{raw / 2**20:.2f} MiB ({raw / wire:.2f}x)")


def print_path(res, extra="", phase="4 main path"):
    s = res["steady"]
    depth = f" at {res['layers']} layers" if "layers" in res else ""
    print(f"[{phase} {res['tag']}] {res.get('arch', 'qwen2-0.5b')}{depth} "
          f"full width, W={res['w']}, "
          f"γ={res['lr']}: {len(res['losses'])} steps, launches "
          f"{res['launches']}; losses "
          f"{['%.4f' % x for x in res['losses']]}{extra}", flush=True)
    spans = ", ".join(fmt.format(s[k]) for k, fmt in SPAN_NAMES.items()
                      if k in s)
    print(f"[{phase} {res['tag']}] step wall {res['wall_ms']:.1f} ms "
          f"(mean of {len(res['losses'])}, first included); device ms, "
          f"mean after the first: {spans}; peak memory "
          f"{res['peak_gib']:.1f} GiB", flush=True)


SMALL_PAIRS = [  # (algorithm, inner optimizer, moment dtype)
    ("vrl_sgd", "sgd", "float32"), ("local_sgd", "sgd", "float32"),
    ("ssgd", "sgd", "float32"), ("stl_sgd", "sgd", "float32"),
    ("easgd", "momentum", "float32"), ("bvr_l_sgd", "adam", "float32"),
    ("vrl_sgd", "adam", "bfloat16")]
# SM3 Adam with two layout-only shards, so the lane stat has S = 2 spans
SMALL_SM3 = ("vrl_sgd", "adam", "float32")


def adam_rule(label, name, diff, atol, lr, steps, k):
    """The rule for Adam runs, card against CPU: all but 1 % of the
    elements within ``atol``, every element within 2γ per step (over k·γ
    for Δ and B, Δ1 and Δ2: ``k`` = 1 for params).  Returns a note."""
    bound = 2 * lr * steps / (1 if k == 1 else k * lr)
    share = float((diff > atol).mean())
    if not (share <= 0.01 and diff.max() <= bound):
        raise AssertionError(
            f"small input {label}: {name} {share:.2%} beyond {atol}, max "
            f"{diff.max()} (bound {bound})")
    return f"{name} {share:.3%} beyond atol, max diff {diff.max():.2e}"


def small_input_agreement(dev) -> None:
    """Each slice at smoke size on the card against the same run on the
    CPU (plain versions, CPU matmuls), from the same parameters."""
    from repro_torch import tree as tm
    from repro_torch.configs import registry
    from repro_torch.configs.base import VRLConfig
    from repro_torch.core import engine as engine_mod
    from repro_torch.data import assigned_token_stream, contiguous_assignment
    from repro_torch.models import transformer
    from repro_torch.train.train_loop import make_train_step

    cfg = registry.smoke_arch("qwen2-0.5b")
    w, k, steps = 2, 2, 7
    params = transformer.init_params(cfg, seed=0)
    attn = params["layers"]["attn"]
    attn["wq"], attn["wk"] = attn["wq"] * 0.1, attn["wk"] * 0.1
    data = assigned_token_stream(contiguous_assignment(w, w), 16,
                                 cfg.vocab_size, steps=steps, batch=2,
                                 alpha=0.05, seed=0)
    from repro_torch.configs.base import EngineConfig
    for alg, inner, mdt, extra in ([pair + ({},) for pair in SMALL_PAIRS]
                                   + [SMALL_SM3 + (dict(
                                       sm3=True,
                                       engine=EngineConfig(shards=2)),)]):
        lr = 1e-3 if inner == "adam" else LR
        vrl = VRLConfig(algorithm=alg, comm_period=k, learning_rate=lr,
                        warmup=True, inner_optimizer=inner,
                        momentum=0.9 if inner == "momentum" else 0.0,
                        moment_dtype=mdt, **extra)
        sched = engine_mod.comm_schedule(vrl)
        rounds = (sched.round_sizes(steps) if sched is not None
                  else (1, k, k, k))
        runs = {}
        for where in ("cpu", dev):
            bundle = make_train_step(cfg, vrl, device=where)
            state = bundle.engine.init(
                tm.tree_map(lambda x: x.to(where), params), w)
            losses, t = [], 0
            for rk in rounds:
                toks = torch.from_numpy(data[t:t + rk]).to(where).long()
                state, lk = bundle.round_step(state, toks,
                                              torch.roll(toks, -1, dims=-1))
                losses += lk.tolist()
                t += rk
            bufs = {"params": state.params, "delta": state.delta,
                    "bias": state.bias}
            runs[str(where)] = (np.array(losses), {
                n: b.float().cpu().numpy() for n, b in bufs.items()
                if isinstance(b, torch.Tensor)})
        (l_c, s_c), (l_g, s_g) = runs["cpu"], runs[str(dev)]
        np.testing.assert_allclose(l_g, l_c, rtol=1e-4)
        notes = []
        for name in s_c:
            atol = 1e-4 if name == "params" else 1e-4 / (k * lr)
            diff = np.abs(s_g[name] - s_c[name])
            if inner == "adam":
                # sign-noise steps: all but 1 % within atol, every element
                # within 2γ per step (over k·γ for Δ and B)
                notes.append(adam_rule(f"{alg}+{inner}", name, diff, atol,
                                       lr, steps,
                                       1 if name == "params" else k))
            else:
                np.testing.assert_allclose(s_g[name], s_c[name], rtol=0,
                                           atol=atol, err_msg=name)
                notes.append(f"{name} max diff {diff.max():.2e}")
        print(f"[5 small input] {alg}+{inner}"
              f"{' (bf16 moments)' if mdt == 'bfloat16' else ''}"
              f"{' + sm3, shards=2' if extra else ''}: "
              f"{len(l_c)} steps, rounds {list(rounds)}, card vs CPU: "
              f"losses max rel diff {np.abs(l_g / l_c - 1).max():.2e}, "
              + ", ".join(notes), flush=True)
    slices = []
    for label, vrl in comm_slices():
        sched = engine_mod.comm_schedule(vrl)
        algo = engine_mod.get_spec(vrl.algorithm)
        rounds = (sched.round_sizes(steps) if sched is not None
                  else (1, k, k, k) if algo.warmup_aware else (k, k, k))
        slices.append((label, vrl, w, rounds, data))
    # the hierarchy's at W = 4 on hier_small_input's stream: 4 rounds of k1
    hier_data = assigned_token_stream(contiguous_assignment(4, 4), 16,
                                      cfg.vocab_size, steps=8, batch=2,
                                      alpha=0.05, seed=0)
    slices += [(label, vrl, 4, (2,) * 4, hier_data)
               for label, vrl in hier_comm_slices()]
    comm_small_input(dev, cfg, params, slices)


def hier_small_input(dev) -> None:
    """hier_vrl_sgd at smoke size, W = 4 (rounds of k1 = 2, 8 steps), on
    the card against the CPU from the same parameters, blocking and
    overlapped, at (P, D) = (2, 2), k2 = 4: losses rtol 1e-4, params and
    pend atol 1e-4, Δ1 1e-4/(k1 γ), Δ2 1e-4/(k2 γ).  Then one pod, (1, 4)
    at k1 = k2 = 2, against the card's flat vrl_sgd at k = 2 (no warmup):
    BITWISE, the same worker mean and arithmetic, Δ2 staying 0."""
    from repro_torch import tree as tm
    from repro_torch.configs import registry
    from repro_torch.configs.base import HierConfig, VRLConfig
    from repro_torch.data import assigned_token_stream, contiguous_assignment
    from repro_torch.models import transformer
    from repro_torch.train.train_loop import make_train_step

    cfg = registry.smoke_arch("qwen2-0.5b")
    w, k1, k2, steps = 4, 2, 4, 8
    params = transformer.init_params(cfg, seed=0)
    attn = params["layers"]["attn"]
    attn["wq"], attn["wk"] = attn["wq"] * 0.1, attn["wk"] * 0.1
    data = assigned_token_stream(contiguous_assignment(w, w), 16,
                                 cfg.vocab_size, steps=steps, batch=2,
                                 alpha=0.05, seed=0)

    def run(vrl, where):
        bundle = make_train_step(cfg, vrl, device=where)
        state = bundle.engine.init(
            tm.tree_map(lambda x: x.to(where), params), w)
        losses = []
        for t in range(0, steps, k1):
            toks = torch.from_numpy(data[t:t + k1]).to(where).long()
            state, lk = bundle.round_step(state, toks,
                                          torch.roll(toks, -1, dims=-1))
            losses += lk.tolist()
        return np.array(losses), state

    def hier(grid, kk2, overlap=False, lr=LR, **inner):
        return VRLConfig(algorithm="hier_vrl_sgd", learning_rate=lr,
                         overlap=overlap,
                         hier=HierConfig(k1=k1, k2=kk2, grid=grid), **inner)
    # (label, config): sgd blocking and overlapped, then momentum,
    # Adam and SM3 Adam with bf16 mu (Adam at γ = 1e-3, as the flat slices)
    slices = [("", hier((2, 2), k2)), (" + overlap", hier((2, 2), k2, True)),
              (" + momentum", hier((2, 2), k2, inner_optimizer="momentum",
                                   momentum=0.9)),
              (" + adam", hier((2, 2), k2, lr=1e-3, inner_optimizer="adam")),
              (" + adam + sm3, bf16 mu",
               hier((2, 2), k2, lr=1e-3, inner_optimizer="adam", sm3=True,
                    moment_dtype="bfloat16"))]
    for label, vrl in slices:
        (l_c, s_c), (l_g, s_g) = run(vrl, "cpu"), run(vrl, dev)
        np.testing.assert_allclose(l_g, l_c, rtol=1e-4)
        lr = vrl.learning_rate
        bufs = {"params": (1e-4, 1), "delta1": (1e-4 / (k1 * lr), k1),
                "delta2": (1e-4 / (k2 * lr), k2)}
        if vrl.overlap:
            bufs["pend"] = (1e-4, 1)
        notes = []
        for name, (atol, kk) in bufs.items():
            a = (s_c.overlap.pend if name == "pend" else getattr(s_c, name))
            b = (s_g.overlap.pend if name == "pend" else getattr(s_g, name))
            a, b = a.numpy(), b.cpu().numpy()
            if vrl.inner_optimizer == "adam":
                notes.append(adam_rule(f"hier{label}", name, np.abs(b - a),
                                       atol, lr, steps, kk))
                continue
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=name)
            notes.append(f"{name} max diff {np.abs(b - a).max():.2e}")
        if (s_g.last_sync1, s_g.last_sync2) != (steps, steps):
            raise AssertionError(f"hier small input: sync counters "
                                 f"{s_g.last_sync1}, {s_g.last_sync2}")
        print(f"[5 small input] hier_vrl_sgd (2, 2), k1={k1}, k2={k2}"
              f"{label}: {steps} steps, card vs "
              f"CPU: losses max rel diff {np.abs(l_g / l_c - 1).max():.2e}, "
              + ", ".join(notes), flush=True)
    l_f, s_f = run(VRLConfig(algorithm="vrl_sgd", comm_period=k1,
                             learning_rate=LR, warmup=False), dev)
    l_h, s_h = run(hier((1, w), k1), dev)
    if not (np.array_equal(l_f, l_h) and torch.equal(s_f.params, s_h.params[0])
            and torch.equal(s_f.delta, s_h.delta1[0])
            and not s_h.delta2.any()):
        raise AssertionError(
            f"hier (1, {w}) is not bitwise flat vrl_sgd on the card: params "
            f"{(s_f.params - s_h.params[0]).abs().max().item()}, Δ "
            f"{(s_f.delta - s_h.delta1[0]).abs().max().item()}, max|Δ2| "
            f"{s_h.delta2.abs().max().item()}")
    print(f"[5 small input] hier_vrl_sgd (1, {w}), k1 = k2 = {k1}: bitwise "
          f"the card's flat vrl_sgd (losses, params, Δ1 = Δ; Δ2 = 0) over "
          f"{steps} steps", flush=True)


SMOKE_ARGS = ["--smoke", "--workers", "2", "--k", "2", "--lr", str(LR),
              "--warmup"]


def comm_slices():
    """(label, VRLConfig) of the compressed and overlapped smoke slices;
    the first is what ``launch.train --compress int8`` builds."""
    from repro_torch.comm import parse_compressor
    from repro_torch.configs.base import VRLConfig
    from repro_torch.launch import train as launch

    def cfg(alg, compress=None, overlap=False, lr=LR):
        return VRLConfig(algorithm=alg, comm_period=2, learning_rate=lr,
                         warmup=True, overlap=overlap,
                         compress=(None if compress is None
                                   else parse_compressor(compress)))
    return [("vrl_sgd+int8 (launch.train --compress int8)",
             launch.vrl_config(launch.parse_args(
                 SMOKE_ARGS + ["--compress", "int8"]))),
            # at γ = 0.05 top-k S-SGD's error-feedback bursts blow the smoke
            # model up by step 6 (loss 6.3 → 32): a run of huge payloads
            # whose flip bound would hold nothing
            ("ssgd+topk:4, γ=0.01", cfg("ssgd", "topk:4", lr=0.01)),
            ("easgd+int8:noef", cfg("easgd", "int8:noef")),
            ("local_sgd+overlap", cfg("local_sgd", overlap=True)),
            ("vrl_sgd+int8+overlap", cfg("vrl_sgd", "int8", overlap=True)),
            # folds at steps 1, 3, 5, 7 miss [1, 1], [0, 0], [0, 0], [0, 1]
            ("vrl_sgd+int8+overlap, deadline 0.25",
             dataclasses.replace(cfg("vrl_sgd", "int8", overlap=True),
                                 deadline=0.25))]


def hier_comm_slices():
    """(label, VRLConfig) of the hierarchy's compressed smoke slices, (P,
    D) = (2, 2) at k1 = 2, k2 = 4: int8 at both levels, the int8 / topk:4
    pair, topk:4:noef at level 2 only (blocking), and topk:4 overlapped
    with deadline 0.25 (its folds at steps 4, 8 miss [1, 0], [0, 1])."""
    from repro_torch.comm import parse_compressor as pc
    from repro_torch.configs.base import HierConfig, VRLConfig

    def cfg(**kw):
        return VRLConfig(algorithm="hier_vrl_sgd", learning_rate=LR,
                         hier=HierConfig(k1=2, k2=4, grid=(2, 2)), **kw)
    return [("hier (2, 2)+int8", cfg(compress=pc("int8"))),
            ("hier (2, 2)+int8 / sync2=topk:4",
             cfg(compress=pc("int8"), compress2=pc("topk:4"))),
            ("hier (2, 2)+sync2=topk:4:noef",
             cfg(compress2=pc("topk:4:noef"))),
            ("hier (2, 2)+topk:4+overlap, deadline 0.25",
             cfg(compress=pc("topk:4"), overlap=True, deadline=0.25))]


# flipped elements one compared buffer may hold (up to 2 measured; a
# planted fault — the residual zeroed, one lane too many kept — flips
# hundreds)
FLIP_CAP = 16


def row_steps(k, p, ref, e) -> np.ndarray:
    """Per row, the most one flipped decision moves an element of the
    decompressed payload (p − ref) + e, the largest over workers (and
    pods), as an (R, 1) array: one int8 level (``k`` None), max|row|/127;
    one top-k pick, the row's kth-largest |x|."""
    x = p - ref if ref is not None else p.clone()
    if e is not None:
        x = x + e
    a = x.abs()
    if k is None:
        step = a.amax(dim=-1) / 127.0
    else:
        step = a.topk(min(k, a.shape[-1]), dim=-1).values[..., -1]
    return step.reshape(-1, step.shape[-1]).amax(dim=0).unsqueeze(
        -1).double().numpy()


@contextlib.contextmanager
def recording_payloads(vu, steps):
    """Within: the EF wrappers (flat and grid) append each round trip's
    ``row_steps`` to ``steps`` before they run it; an engine built here
    keeps them."""
    names = ("fused_ef_int8", "fused_ef_topk", "fused_ef_int8_grid",
             "fused_ef_topk_grid")
    saved = {n: getattr(vu, n) for n in names}

    def recording(fn):
        def ef(p, ref, e, **kw):
            steps.append(row_steps(kw.get("k"), p, ref, e))
            return fn(p, ref, e, **kw)
        return ef
    for n in names:
        setattr(vu, n, recording(saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(vu, n, fn)


def state_buffers(state) -> dict:
    """Every buffer of a flat or hier engine state by name: the worker
    buffers, the comm state's, and pend."""
    bufs = {name: getattr(state, name) for name in
            ("params", "delta", "bias", "center", "delta1", "delta2")
            if hasattr(state, name)}
    if state.comm != ():
        bufs.update(state.comm._asdict())
    if state.overlap != ():
        bufs["pend"] = state.overlap.pend
    return {n: b for n, b in bufs.items() if isinstance(b, torch.Tensor)}


def comm_small_input(dev, cfg, params, slices):
    """The compressed, overlapped and deadline slices, card against CPU,
    both through ``round_step``: every element within the uncompressed
    slices' tolerances but at most ``FLIP_CAP`` per buffer, those within
    twice the summed row step of the CPU run's communications (Δ, B, Δ1
    and Δ2 over k·γ, k the flat period or k1); losses rtol 1e-4.
    ``slices``: (label, VRLConfig, workers, round sizes, token stream)."""
    from repro_torch import tree as tm
    from repro_torch.comm import resolve_pair
    from repro_torch.core import engine as engine_mod
    from repro_torch.kernels import vrl_update as vu
    from repro_torch.train.train_loop import make_train_step

    for label, vrl, w, rounds, data in slices:
        algo = engine_mod.get_spec(vrl.algorithm)
        k = rounds[-1]
        compressed = any(c is not None for c in resolve_pair(vrl))
        rows = []
        runs = {}
        for where in ("cpu", dev):
            if where == "cpu" and compressed:
                with recording_payloads(vu, rows):
                    bundle = make_train_step(cfg, vrl, device=where)
            else:
                bundle = make_train_step(cfg, vrl, device=where)
            state = bundle.engine.init(
                tm.tree_map(lambda x: x.to(where), params), w)
            losses, t = [], 0
            for rk in rounds:
                toks = torch.from_numpy(data[t:t + rk]).to(where).long()
                state, lk = bundle.round_step(state, toks,
                                              torch.roll(toks, -1, dims=-1))
                losses += lk.tolist()
                t += rk
            runs[str(where)] = (np.array(losses), {
                n: b.float().cpu().numpy()
                for n, b in state_buffers(state).items()})
        (l_c, s_c), (l_g, s_g) = runs["cpu"], runs[str(dev)]
        np.testing.assert_allclose(l_g, l_c, rtol=1e-4)
        # S-SGD's flips move a gradient, so its parameters by γ times it
        resid_b = 2 * sum(rows) if rows else 0.0
        param_b = resid_b * (vrl.learning_rate if algo.grad_all_reduce
                             else 1.0)
        notes = []
        for name in s_c:
            scale = (1 / (k * vrl.learning_rate)
                     if name in ("delta", "bias", "delta1", "delta2") else 1)
            fb = np.broadcast_to(scale * (resid_b if name.startswith("resid")
                                          else param_b), s_c[name].shape)
            diff = np.abs(s_g[name] - s_c[name])
            flipped = diff > 1e-4 * scale
            n, cap = int(flipped.sum()), FLIP_CAP
            if n > cap or not np.all(diff[flipped] <= fb[flipped]):
                raise AssertionError(
                    f"small input {label}: {name} differs by {diff.max()} "
                    f"at {n} elements beyond atol {1e-4 * scale} (at most "
                    f"{cap} may flip, each within its row's flip bound, "
                    f"largest {fb.max()})")
            notes.append(f"{name} max diff {diff.max():.2e}, {n} flipped "
                         f"(cap {cap})")
        print(f"[5 small input] {label}: {len(l_c)} steps, rounds "
              f"{list(rounds)}, card vs CPU: losses max rel diff "
              f"{np.abs(l_g / l_c - 1).max():.2e}, {len(rows)} compressed "
              f"communications, row flip bound max "
              f"{np.max(param_b):.2e} / median {np.median(param_b):.2e} "
              f"(resid max {np.max(resid_b):.2e}), " + ", ".join(notes),
              flush=True)


# ------------------------------------------- the per-leaf pair (tree API)
LEAF_MODERATE = [(1,), (105,), (1000,), (2 ** 16 + 3,), (64, 64),
                 (4, 130, 7)]
LEAF_DTYPES = [(torch.float32,) * 3,
               (torch.bfloat16, torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.float32, torch.bfloat16)]
LEAF_K, LEAF_LR = 3, 0.07       # the sync's inv_kg = 1/(k·γ)


def leaf_inputs(seed, shape, dts, dev, offset=0, nan=False):
    """Three operands of ``shape`` in the dtypes ``dts`` from numpy; with
    ``offset`` each a view one element into its buffer (not 16-byte
    aligned); with ``nan`` a NaN planted in each."""
    rng = np.random.RandomState(seed)
    n = math.prod(shape)
    out = []
    for i, dt in enumerate(dts):
        x = rng.randn(n + offset).astype(np.float32)
        if nan:
            x[offset + (7 * i) % n] = np.nan
        out.append(torch.from_numpy(x).to(dev).to(dt)[offset:].view(shape))
    return out


def leaf_moderate_checks(chk, dev) -> int:
    """Phase 3 for the per-leaf pair: ragged sizes (n = 1, 105, 1000,
    2^16 + 3) and the tests' shapes, fp32 and bf16 operands (Δ rounded to
    p's dtype in the local kernel), views one element off 16-byte
    alignment, x̂ of p's shape and x̂ broadcast over a worker axis (stride
    0, not materialised), and NaNs planted in every operand (NaN for
    NaN).  Returns the number of checks."""
    inv_kg = 1.0 / (LEAF_K * LEAF_LR)
    n0 = chk.count
    for seed, shape in enumerate(LEAF_MODERATE):
        for dts in LEAF_DTYPES:
            for offset in (0, 1):
                tag = f"({shape}, {[str(d)[6:] for d in dts]}, +{offset})"
                p, g, d = leaf_inputs(seed, shape, dts, dev, offset)
                chk.run("vrl_local_update", (p, g, d), tag, lr=0.03)
                chk.run("vrl_sync_update", (p, g, d), tag, inv_kg=inv_kg)
            p, g, d = leaf_inputs(seed, (4,) + shape, dts, dev)
            xb = leaf_inputs(seed + 50, shape, dts[1:2], dev)[0]
            chk.run("vrl_sync_update", (p, xb, d),
                    f"(4 workers x {shape}, x̂ broadcast)", inv_kg=inv_kg)
            if math.prod(shape) >= 105:
                p, g, d = leaf_inputs(seed, shape, dts, dev, nan=True)
                chk.run("vrl_local_update", (p, g, d), f"({shape}, NaN)",
                        nan=True, lr=0.03)
                chk.run("vrl_sync_update", (p, g, d), f"({shape}, NaN)",
                        nan=True, inv_kg=inv_kg)
    return chk.count - n0


def leaf_full_width(chk, vu, tu, dev):
    """Phase 3 at full width: the W = 4 worker-stacked qwen2-0.5b tree as
    the per-leaf executor holds it (494,032,768 parameters per worker,
    built from the seed), fp32, then p and g (and x̂) in bf16 with an fp32
    Δ: each kernel bitwise its plain version leaf by leaf, then the
    tree-update API call (one launch per leaf) and the plain versions over
    the tree timed with CUDA events beside the byte bound.  Returns
    {kernel: ms}, {kernel: plain ms}, {kernel: (bound ms, bound by)} of the
    fp32 run."""
    from repro_torch import tree as tm
    from repro_torch.configs import registry
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    w = FULL[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cfg = registry.get_arch("qwen2-0.5b")
    params = transformer.init_params(cfg, 0, device=dev)
    p = tm.tree_map(lambda x: x.expand(w, *x.shape).clone(
        memory_format=torch.contiguous_format), params)
    del params
    leaves = len(tm.leaves(p))
    n = sum(x.numel() for x in tm.leaves(p))
    if n != w * FULL_PARAMS:
        raise AssertionError(f"full-width tree holds {n} elements")

    def randn_like(tree, scale=1.0):
        return tm.tree_map(lambda x: torch.randn(
            x.shape, generator=gen, device=dev).mul_(scale), tree)
    g, d = randn_like(p), randn_like(p, 0.01)
    inv_kg = 1.0 / (2 * LR)
    times, plain, bounds = {}, {}, {}
    for label, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        pp = tm.tree_map(lambda x: x.to(dt), p)
        gg = tm.tree_map(lambda x: x.to(dt), g)
        xb = tm.tree_map(lambda x: x.mean(dim=0), pp)
        paths = [path for path, _ in tm.leaves_with_path(pp)]
        for path, a, b, c, x in zip(paths, tm.leaves(pp), tm.leaves(gg),
                                    tm.leaves(d), tm.leaves(xb)):
            chk.run("vrl_local_update", (a, b, c),
                    f"full width {label} {path}", lr=LR)
            chk.run("vrl_sync_update", (a, x, c),
                    f"full width {label} {path}", inv_kg=inv_kg)
        free()
        calls = {"vrl_local_update": (
            lambda: ops.vrl_local_update_tree(pp, gg, d, lr=LR),
            lambda: tm.tree_map(lambda a, b, c: tu.vrl_local_update(
                a, b, c, lr=LR), pp, gg, d)),
            "vrl_sync_update": (
            lambda: ops.vrl_sync_update_tree(pp, xb, d, k=2, lr=LR),
            lambda: tm.tree_map(lambda a, x, c: tu.vrl_sync_update(
                a, x, c, inv_kg=inv_kg), pp, xb, d))}
        item = (dt.itemsize, dt.itemsize, 4)
        for name, (kernel, plain_fn) in calls.items():
            n0 = vu.LAUNCHES[name]
            kernel()
            torch.cuda.synchronize()
            per_call = vu.LAUNCHES[name] - n0
            if per_call != leaves:
                raise AssertionError(f"{name}: {per_call} launches per tree "
                                     f"call, the tree has {leaves} leaves")
            t = time_ms(kernel, 10, warmup=2)
            free()
            tp = time_ms(plain_fn, 3)
            free()
            b, by = bound_ms(*leaf_cost(n, n // w,
                                        name == "vrl_local_update", item))
            if label == "fp32":
                times[name], plain[name], bounds[name] = t, tp, (b, by)
            print(f"[3 kernels] {name} over the W=4 qwen2-0.5b tree "
                  f"({leaves} leaves, {label} p and g, fp32 Δ): {t:.3f} ms "
                  f"per tree call of {per_call} launches (bound {b:.3f} ms "
                  f"by {by}, {100 * b / t:.1f}% of 3.35 TB/s); plain "
                  f"{tp:.3f} ms; bitwise the plain version leaf by leaf",
                  flush=True)
        del pp, gg, xb, calls
        free()
    del p, g, d
    free()
    return times, plain, bounds


def tree_api_path(dev, vu):
    """Path (r): VRL-SGD through the tree-update API at full width — the
    per-leaf state of ``update_backend="reference"`` (W = 4, batch 8,
    seq 64), its ``grads_fn`` for each step's gradients, then
    ``vrl_local_update_tree`` every step and the worker mean plus
    ``vrl_sync_update_tree`` every k = 2 steps, 2 rounds.  The launch
    counters are zeroed just before and read just after: each tree call
    launches its kernel once per leaf.  Every loss finite; Σ_i Δ_i ≈ 0
    after every sync (1e-4 · max|Δ| plus the fp32 rounding of x̂)."""
    from repro_torch import tree as tm
    from repro_torch.configs import registry
    from repro_torch.configs.base import VRLConfig
    from repro_torch.core import engine as engine_mod
    from repro_torch.data import assigned_token_stream, contiguous_assignment
    from repro_torch.kernels import ops
    from repro_torch.train.train_loop import make_train_step

    cfg = qwen_cut()
    w, k, rounds = 4, 2, 2
    vrl = VRLConfig(algorithm="vrl_sgd", comm_period=k, learning_rate=MAIN_LR,
                    weight_decay=0.0, update_backend="reference")
    bundle = make_train_step(cfg, vrl, device=dev)
    state = bundle.init_state(0, w)
    leaves = len(tm.leaves(state.params))
    data = assigned_token_stream(contiguous_assignment(w, w), 64,
                                 cfg.vocab_size, steps=k * rounds, batch=8,
                                 alpha=0.05, seed=0)
    vu.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, sums, t0 = [], [], time.perf_counter()
    for t in range(k * rounds):
        toks = torch.from_numpy(data[t]).to(dev, torch.long)
        grads, loss = bundle.grads_fn(state, toks,
                                      torch.roll(toks, -1, dims=-1))
        params = ops.vrl_local_update_tree(state.params, grads, state.delta,
                                           lr=MAIN_LR)
        del grads
        delta = state.delta
        if (t + 1) % k == 0:
            xbar = engine_mod.worker_mean(params)
            params, delta = ops.vrl_sync_update_tree(params, xbar, delta,
                                                     k=k, lr=MAIN_LR)
            del xbar
        state = state._replace(params=params, delta=delta, step=t + 1)
        del params, delta
        losses.append(loss.item())
        if (t + 1) % k == 0:
            sums.append(engine_mod.sum_invariant(state.delta)
                        + (max(x.abs().max().item()
                               for x in tm.leaves(state.params)),))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(vu.LAUNCHES)
    check_launches("(r)", launches, {"vrl_local_update": k * rounds * leaves,
                                     "vrl_sync_update": rounds * leaves})
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"path (r): non-finite loss {losses}")
    max_d = max(m for _, m, _ in sums)
    rounding = sum(2 * w * float(np.spacing(np.float32(mp))) / (k * MAIN_LR)
                   for _, _, mp in sums)
    if not sums[-1][0] <= 1e-4 * max_d + rounding:
        raise AssertionError(f"path (r): Σ_i Δ_i not ~0 after the last sync: "
                             f"{sums}")
    out = path_result("(r) vrl_sgd+sgd via the tree-update API", losses,
                      wall, {}, launches, MAIN_LR, layers=cfg.num_layers)
    print_path(out, f"; {leaves} leaves, each tree call one launch per leaf; "
               f"max|ΣΔ| {sums[-1][0]:.3e} <= 1e-4 * max|Δ| {max_d:.3e} + "
               f"x̂ rounding {rounding:.3e}")
    del bundle, state
    free()
    return out


def ref_small_input(dev) -> None:
    """Phase 5 for the per-leaf executor: smoke size, the card against the
    CPU from the same parameters (wq, wk × 0.1), through ``round_step`` of
    ``update_backend="reference"``: vrl_sgd + sgd, easgd + momentum and
    bvr_l_sgd + adam (W = 2, rounds of 1, 2, 2, 2), the hierarchy (2, 2)
    at k1 = 2, k2 = 4 with int8 (W = 4, 4 rounds); losses rtol 1e-4,
    params (center, refs, residuals) atol 1e-4, Δ and B atol 1e-4/(k·γ),
    Adam under the Adam rule, int8 under the flip rule (at most
    ``FLIP_CAP`` elements of a tree beyond atol, each within twice the
    summed largest row step of the CPU run's payloads, recorded from
    ``ef_leaf``).  Then the card's per-leaf executor against the card's
    flat engine over one round (k = 2) from identical states: params and
    Δ atol 1e-5 (the reference's)."""
    from repro_torch import tree as tm
    from repro_torch.comm import compressors as comm_mod
    from repro_torch.comm import parse_compressor
    from repro_torch.configs import registry
    from repro_torch.configs.base import HierConfig, VRLConfig
    from repro_torch.core import get_algorithm
    from repro_torch.data import assigned_token_stream, contiguous_assignment
    from repro_torch.models import transformer
    from repro_torch.train.train_loop import make_train_step

    cfg = registry.smoke_arch("qwen2-0.5b")
    params = transformer.init_params(cfg, seed=0)
    attn = params["layers"]["attn"]
    attn["wq"], attn["wk"] = attn["wq"] * 0.1, attn["wk"] * 0.1
    hier = HierConfig(k1=2, k2=4, grid=(2, 2))
    slices = [
        ("vrl_sgd+sgd", VRLConfig(algorithm="vrl_sgd", comm_period=2,
                                  learning_rate=LR, warmup=True), 2,
         (1, 2, 2, 2)),
        ("easgd+momentum", VRLConfig(algorithm="easgd", comm_period=2,
                                     learning_rate=LR,
                                     inner_optimizer="momentum",
                                     momentum=0.9), 2, (2, 2, 2)),
        ("bvr_l_sgd+adam", VRLConfig(algorithm="bvr_l_sgd", comm_period=2,
                                     learning_rate=1e-3, warmup=True,
                                     inner_optimizer="adam"), 2,
         (1, 2, 2, 2)),
        ("hier (2, 2)+int8", VRLConfig(algorithm="hier_vrl_sgd",
                                       learning_rate=LR, hier=hier,
                                       compress=parse_compressor("int8")),
         4, (2, 2, 2, 2))]

    def run(vrl, w, rounds, where, data):
        vrl = dataclasses.replace(vrl, update_backend="reference")
        bundle = make_train_step(cfg, vrl, device=where)
        state = get_algorithm(vrl.algorithm).init(
            vrl, tm.tree_map(lambda x: x.to(where), params),
            hier.grid if vrl.hier is not None else w)
        losses, t = [], 0
        for rk in rounds:
            toks = torch.from_numpy(data[t:t + rk]).to(where).long()
            state, lk = bundle.round_step(state, toks,
                                          torch.roll(toks, -1, dims=-1))
            losses += lk.tolist()
            t += rk
        return np.array(losses), state

    for label, vrl, w, rounds in slices:
        data = assigned_token_stream(contiguous_assignment(w, w), 16,
                                     cfg.vocab_size, steps=sum(rounds),
                                     batch=2, alpha=0.05, seed=0)
        steps_rec = []
        saved = comm_mod.ef_leaf

        def recording(spec, payload, n_lead, lanes=256):
            a = payload.abs().double().reshape(-1)
            a = torch.nn.functional.pad(a, (0, (-a.numel()) % lanes))
            rows = a.reshape(-1, lanes).amax(dim=-1)
            steps_rec.append(float(rows.max()) / 127.0)
            return saved(spec, payload, n_lead, lanes)
        comm_mod.ef_leaf = recording
        try:
            l_c, s_c = run(vrl, w, rounds, "cpu", data)
        finally:
            comm_mod.ef_leaf = saved
        l_g, s_g = run(vrl, w, rounds, dev, data)
        np.testing.assert_allclose(l_g, l_c, rtol=1e-4)
        k = 2
        flip = 2 * sum(steps_rec)
        notes = []
        bufs = dict(s_c._asdict())
        if s_c.comm != ():
            bufs.update({f"comm.{n}": v for n, v in s_c.comm._asdict().items()})
        for name, tree_c in bufs.items():
            tree_g = (getattr(s_g.comm, name[5:]) if name.startswith("comm.")
                      else getattr(s_g, name))
            if not isinstance(tree_c, dict) or name == "inner":
                continue
            scale = (1 / (k * vrl.learning_rate)
                     if name in ("delta", "bias", "delta1", "delta2") else 1)
            atol = 1e-4 * scale
            diff = np.concatenate([
                np.abs(b.float().cpu().numpy() - a.float().numpy()).ravel()
                for a, b in zip(tm.leaves(tree_c), tm.leaves(tree_g))])
            if vrl.inner_optimizer == "adam":
                notes.append(adam_rule(label, name, diff, atol,
                                       vrl.learning_rate, sum(rounds),
                                       1 if scale == 1 else k))
                continue
            flipped = diff > atol
            nf = int(flipped.sum())
            if nf > (FLIP_CAP if vrl.compress is not None else 0) or \
                    not np.all(diff[flipped] <= flip * scale):
                raise AssertionError(
                    f"per-leaf small input {label}: {name} differs by "
                    f"{diff.max()} at {nf} elements beyond {atol}")
            notes.append(f"{name} max diff {diff.max():.2e}"
                         + (f", {nf} flipped" if vrl.compress else ""))
        print(f"[5 small input] per-leaf {label}: {len(l_c)} steps, card "
              f"vs CPU: losses max rel diff "
              f"{np.abs(l_g / l_c - 1).max():.2e}, " + ", ".join(notes),
              flush=True)
    # the card's two executors, one round from identical states
    vrl = VRLConfig(algorithm="vrl_sgd", comm_period=2, learning_rate=LR)
    data = assigned_token_stream(contiguous_assignment(2, 2), 16,
                                 cfg.vocab_size, steps=2, batch=2,
                                 alpha=0.05, seed=1)
    _, s_ref = run(vrl, 2, (2,), dev, data)
    flat_b = make_train_step(cfg, vrl, device=dev)
    s_flat = flat_b.engine.init(tm.tree_map(lambda x: x.to(dev), params), 2)
    toks = torch.from_numpy(data[:2]).to(dev).long()
    s_flat, _ = flat_b.round_step(s_flat, toks, torch.roll(toks, -1, dims=-1))
    diffs = {}
    for name, a, b, atol in (
            ("params", s_ref.params, flat_b.engine.params_tree(s_flat),
             1e-5),
            ("delta", s_ref.delta, _delta_tree(flat_b.engine, s_flat),
             1e-5)):
        diffs[name] = max((x - y).abs().max().item() for x, y in zip(
            tm.leaves(a), tm.leaves(b)))
        if diffs[name] > atol:
            raise AssertionError(f"per-leaf vs flat engine on the card: "
                                 f"{name} differs by {diffs[name]}")
    print(f"[5 small input] per-leaf vs flat engine on the card, vrl_sgd, "
          f"one round of 2 from identical states: params max diff "
          f"{diffs['params']:.2e}, Δ max diff {diffs['delta']:.2e} "
          f"(atol 1e-5)", flush=True)


# ---------------------------------------- the attention op (to a tolerance)
def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |x| (8 significant bits), x in fp32."""
    _, e = torch.frexp(x.abs())
    return torch.ldexp(torch.ones_like(x), e.clamp_min(-125) - 8)


def attention_close(got, want, tag) -> tuple:
    """The kernel's output against the plain version's: fp32 within rtol
    2e-4 and atol 2e-5 (the reference's own tolerance); bf16 within one
    bf16 ulp of the output beyond that (both compute in fp32 and round
    once; an output near zero is a cancelling sum whose fp32 error is more
    than a bf16 ulp there).  Returns (max abs err, elements more than one
    bf16 ulp apart)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"flash_attention {tag}: {got.dtype} "
                             f"{tuple(got.shape)} vs {want.dtype} "
                             f"{tuple(want.shape)}")
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = 2e-5 + 2e-4 * w.abs()
    past_ulp = 0
    if got.dtype == torch.bfloat16:
        ulp = bf16_ulp(torch.maximum(g.abs(), w.abs()))
        past_ulp = int((err > ulp).sum())
        bound = bound + ulp
    bad = int((err > bound).sum())
    if bad or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"flash_attention {tag}: {bad} elements past "
                             f"the tolerance (max abs err "
                             f"{err.max().item():.3e}) or not finite")
    return err.max().item(), past_ulp


def attention_moderate_checks(dev):
    """The attention op on the card against its plain version: B ∈ {1, 2};
    ragged S ∈ {1, 100, 257, 512} (padded to the block, 64 or 128); D ∈
    {16, 32, 64, 128}; GQA groups 1, 2, 7; causal on and off; window None,
    16, 64; fp32 and bf16.  Then the (BH, S, D) wrapper; then scores of
    large magnitude (q · 10) and D = 128 at S = 2048, causal on and off
    and window 512.  Returns the number of checks and {dtype: (max abs
    err, elements past one ulp)}."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    worst = {torch.float32: [0.0, 0], torch.bfloat16: [0.0, 0]}
    n = 0

    def check(got, want, dt, tag):
        nonlocal n
        err, past = attention_close(got, want, tag)
        worst[dt][0] = max(worst[dt][0], err)
        worst[dt][1] += past
        n += 1

    for d in (16, 32, 64, 128):
        for dt in (torch.float32, torch.bfloat16):
            i = 0
            for s in (1, 100, 257, 512):
                for causal in (True, False):
                    for window in (None, 16, 64):
                        for group in (1, 2, 7):
                            b, kvh = 1 + i % 2, 1 + (i // 2) % 2
                            blk = (64, 128)[(i // 3) % 2]
                            i += 1
                            q = torch.randn(b, s, group * kvh, d,
                                            generator=gen, device=dev)
                            k, v = (torch.randn(b, s, kvh, d, generator=gen,
                                                device=dev)
                                    for _ in range(2))
                            q, k, v = (x.to(dt) for x in (q, k, v))
                            kw = dict(causal=causal, window=window,
                                      block_q=blk, block_k=blk)
                            check(ops.mha_flash(q, k, v, **kw),
                                  fa.mha_flash_ref(q, k, v, **kw), dt,
                                  f"({b}, {s}, {group * kvh}, {kvh}, {d}) "
                                  f"{dt} {kw}")
            q, k, v = (torch.randn(6, 256, d, generator=gen,
                                   device=dev).to(dt) for _ in range(3))
            for causal, window in ((True, None), (False, None),
                                   (True, 100)):
                check(fa.flash_attention(q, k, v, causal=causal,
                                         window=window),
                      fa.flash_attention_ref(q, k, v, causal=causal,
                                             window=window), dt,
                      f"(6, 256, {d}) {dt} causal {causal} window {window}")
    # scores of large magnitude (q · 10: |s| ~ 80, a sharply peaked
    # softmax), and D = 128 over S = 2048 (many key tiles a query tile)
    for dt in (torch.float32, torch.bfloat16):
        for (b, s, h, kvh, d), scale in (((2, 512, 4, 2, 64), 10.0),
                                         ((1, 2048, 4, 2, 128), 1.0)):
            q, k, v = (torch.randn(b, s, m, d, generator=gen, device=dev)
                       for m in (h, kvh, kvh))
            q, k, v = (q * scale).to(dt), k.to(dt), v.to(dt)
            for causal, window in ((True, None), (False, None),
                                   (True, 512)):
                kw = dict(causal=causal, window=window)
                check(ops.mha_flash(q, k, v, **kw),
                      fa.mha_flash_ref(q, k, v, **kw), dt,
                      f"({b}, {s}, {h}, {kvh}, {d}) q × {scale} {dt} {kw}")
    torch.cuda.synchronize()
    return n, worst


def sdpa_call(q, k, v, window):
    """The library yardstick, timed only (the port never calls it):
    ``scaled_dot_product_attention`` on the repeated (B, H, S, D) tensors,
    causal, the window as a boolean mask."""
    F = torch.nn.functional
    group = q.shape[2] // k.shape[2]
    qh = q.transpose(1, 2).contiguous()
    kh, vh = (x.repeat_interleave(group, dim=2).transpose(1, 2).contiguous()
              for x in (k, v))
    if window is None:
        return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=True)
    pos = torch.arange(q.shape[1], device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] >
                                             pos[:, None] - window)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                  attn_mask=mask)


def attention_full_width(dev):
    """The attention op's path: ``kernels.mha_flash`` at the two served
    models' prefill widths (ATTN_FULL), fp32 and bf16, window None and
    512, its launch count zeroed just before and read just after; then
    each output against the plain version, the kernel's time (CUDA
    events), the plain version's, SDPA's and the bound.  Returns the
    launches and {(model, dtype, window): numbers}."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    cases = [(m, dt, w) for m in ATTN_FULL
             for dt in (torch.float32, torch.bfloat16) for w in ATTN_WINDOWS]
    inputs = {}
    for model, dt, w in cases:
        b, s, h, kvh, d = ATTN_FULL[model]
        inputs[model, dt, w] = tuple(
            torch.randn(b, s, n, d, generator=gen, device=dev).to(dt)
            for n in (h, kvh, kvh))
    fa.reset_launches()
    outs = {c: kernels.mha_flash(*inputs[c], window=c[2]) for c in cases}
    torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_attention"]
    if launches != len(cases):
        raise AssertionError(f"mha_flash: {launches} launches for "
                             f"{len(cases)} calls")
    rows = {}
    for c in cases:
        model, dt, w = c
        q, k, v = inputs[c]
        tag = f"{model} {ATTN_FULL[model]} {dt} window {w}"
        err, past = attention_close(outs[c], fa.mha_flash_ref(q, k, v,
                                                              window=w), tag)
        free()
        ms = time_ms(lambda: kernels.mha_flash(q, k, v, window=w), 10,
                     warmup=2)
        plain = time_ms(lambda: fa.mha_flash_ref(q, k, v, window=w), 3)
        free()
        library = time_ms(sdpa_call(q, k, v, w), 10, warmup=2)
        free()
        nbytes, flops, tc = attention_cost(*ATTN_FULL[model], w,
                                           dt.itemsize)
        b_ms, by = bound_ms(nbytes, *tc)
        core_ms, _ = bound_ms(nbytes, flops)
        rows[c] = dict(ms=ms, plain=plain, library=library, bound=b_ms,
                       by=by, core_bound=core_ms, err=err)
        print(f"[3 kernels] flash_attention via mha_flash at {tag}: "
              f"{ms:.3f} ms; tensor-core "
              f"bound {b_ms:.3f} ms by {by}, {100 * b_ms / ms:.1f}%; fp32 "
              f"CUDA-core bound {core_ms:.3f} ms, {100 * core_ms / ms:.1f}%; "
              f"plain {plain:.3f} ms; SDPA ({str(dt)[6:]}) {library:.3f} ms; "
              f"max abs err vs plain {err:.3e}"
              + (f" ({past} elements one bf16 ulp apart)"
                 if dt == torch.bfloat16 else ""), flush=True)
    del outs, inputs
    free()
    return launches, rows


# ------------------------------------------- the SSD op (to a tolerance)
def ssd_close(got, want, tag) -> tuple:
    """The SSD kernel's output against the plain version's: fp32 within
    rtol 2e-4 and atol 2e-5 · max(1, max|want|) — the reference tests'
    tolerance on unit-scale outputs, scaled with the output: at Q = 256
    cum falls by hundreds within a chunk, and the plain version's fp32
    prefix sums carry ulp(|cum|) into every decay (its own error against
    an fp64 evaluation reaches 1.2 × the unscaled bound) — bf16 within one
    bf16 ulp of the output beyond that.  Returns (max abs err, the largest
    err / bound)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"ssd_scan {tag}: {got.dtype} "
                             f"{tuple(got.shape)} vs {want.dtype} "
                             f"{tuple(want.shape)}")
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = 2e-5 * max(1.0, w.abs().max().item()) + 2e-4 * w.abs()
    if got.dtype == torch.bfloat16:
        bound = bound + bf16_ulp(torch.maximum(g.abs(), w.abs()))
    bad = int((err > bound).sum())
    if bad or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"ssd_scan {tag}: {bad} elements past the "
                             f"tolerance (max abs err "
                             f"{err.max().item():.3e}) or not finite")
    return err.max().item(), (err / bound).max().item()


def ssd_inputs(seed, b, l, h, p, n, dev, dtype, a_shift=0.0):
    """Drawn with numpy like the reference tests' (tests/test_kernels.py):
    x ~ N(0, 1), dt = softplus(N(0, 1)), a_log ~ 0.5 N(0, 1) (+ a_shift),
    B, C ~ 0.3 N(0, 1); a_log stays fp32."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, l, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, l, h))).astype(np.float32)
    a_log = (rng.randn(h) * 0.5 + a_shift).astype(np.float32)
    bb = (rng.randn(b, l, n) * 0.3).astype(np.float32)
    cc = (rng.randn(b, l, n) * 0.3).astype(np.float32)
    x, dt, bb, cc = (torch.from_numpy(t).to(device=dev, dtype=dtype)
                     for t in (x, dt, bb, cc))
    return x, dt, torch.from_numpy(a_log).to(dev), bb, cc


def ssd_moderate_checks(dev):
    """The SSD op on the card against its plain version: P ∈ {16, 64}, N ∈
    {8, 128}, Q ∈ {16, 64, 256} with 1 to 8 chunks, L a chunk multiple or
    ragged (a short last chunk; with one chunk, chunk = L), B ∈ {1, 2} and
    H ∈ {1, 3, 32} in turn, fp32 and bf16; then an a_log near 1.5 that
    drives cum below −100 inside a chunk, the (BH, L, P) wrapper with a
    per-(batch, head) a_log, and mixed dtypes of x, dt, B and C.  Returns the number of checks and {y's
    dtype: (max abs err, largest err / bound)}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    worst = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
    n_checks = 0

    def check(got, want, dt, tag):
        nonlocal n_checks
        err, ratio = ssd_close(got, want, tag)
        worst[dt][0] = max(worst[dt][0], err)
        worst[dt][1] = max(worst[dt][1], ratio)
        n_checks += 1

    i = 0
    for p in (16, 64):
        for n in (8, 128):
            for q, nc in ((16, 1), (16, 8), (64, 3), (256, 1), (256, 8)):
                for ragged in (False, True):
                    b, h = 1 + i % 2, (1, 3, 32)[i % 3]
                    l = nc * q - (q // 3 + 1 if ragged else 0)
                    for dt in (torch.float32, torch.bfloat16):
                        args = ssd_inputs(i, b, l, h, p, n, dev, dt)
                        check(ops.ssd_chunk_scan(*args, chunk=q),
                              ss.ssd_chunk_scan_ref(*args, chunk=q), dt,
                              f"({b}, {l}, {h}, {p}, {n}) chunk {q} {dt}")
                    i += 1
    for dt in (torch.float32, torch.bfloat16):
        for b, l, h in ((2, 512, 3), (1, 2048, 32)):
            args = ssd_inputs(7 + l, b, l, h, 64, 128, dev, dt, a_shift=1.5)
            cum = (args[1].float() * torch.exp(args[2])).reshape(
                b, l // 256, 256, h).sum(2)
            if cum.min().item() < 100:
                raise AssertionError(f"the overflow case's cum falls only "
                                     f"{cum.min().item()} in a chunk")
            check(ops.ssd_chunk_scan(*args, chunk=256),
                  ss.ssd_chunk_scan_ref(*args, chunk=256), dt,
                  f"({b}, {l}, {h}, 64, 128) a_log + 1.5 {dt}")
        x, dtt, _, bb, cc = ssd_inputs(3, 2, 192, 3, 32, 16, dev, dt)
        xt = x.transpose(1, 2).reshape(6, 192, 32).contiguous()
        dtt = dtt.transpose(1, 2).reshape(6, 192).contiguous()
        alog = torch.from_numpy(np.random.RandomState(4).randn(6, 1).astype(
            np.float32) * 0.5).to(dev)
        check(ss.ssd_scan(xt, dtt, alog, bb, cc, chunk=64, num_heads=3),
              ss.ssd_scan_ref(xt, dtt, alog, bb, cc, chunk=64, num_heads=3),
              dt, f"(BH, L, P) = (6, 192, 32) {dt}")
    bf, f32 = torch.bfloat16, torch.float32
    for dts in ((bf, f32, f32, f32), (f32, bf, bf, bf), (bf, f32, bf, bf),
                (f32, f32, bf, f32)):
        x, dtt, a_log, bb, cc = ssd_inputs(12, 2, 300, 32, 64, 128, dev,
                                             f32)
        args = (x.to(dts[0]), dtt.to(dts[1]), a_log, bb.to(dts[2]),
                cc.to(dts[3]))
        check(ops.ssd_chunk_scan(*args, chunk=256),
              ss.ssd_chunk_scan_ref(*args, chunk=256), dts[0],
              f"(2, 300, 32, 64, 128) x, dt, B, C {dts}")
    torch.cuda.synchronize()
    return n_checks, worst


def ssd_full_width(dev):
    """The SSD op's path: mamba2-370m's layer 0 at full width (random
    weights from seed 0, token ids (4, 2048)): its x, dt, B and C as
    ``ssm_forward`` makes them, then ``kernels.ssd_chunk_scan(chunk=256)``
    with the launch count zeroed just before and read just after (1
    launch); the output against the plain version and against the model's
    own ``ssd_chunked`` (within 1e-4 · max(1, max|y|): the reference's
    1e-4 on unit-scale outputs, scaled); the kernel's time (CUDA events),
    the plain version's and the bound; library: none.  Then the same in
    bf16 (x, dt, B, C rounded), against the bf16 plain version.  Returns
    the launches and {dtype: numbers}."""
    from repro_torch import kernels
    from repro_torch.configs import registry
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import ssm, transformer
    from repro_torch.models.layers import rms_norm
    cfg = registry.get_arch(MAMBA)
    b, l, q = SSD_FULL
    h, hd, n = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
    params = transformer.init_params(cfg, seed=0, device=dev)
    p0 = {k: v[0] for k, v in params["layers"]["ssm"].items()}
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (b, l), generator=gen).to(dev)
    with torch.no_grad():
        u = rms_norm(params["embed"][toks], params["layers"]["norm1"][0],
                     cfg.norm_eps)
        x = ssm._causal_conv(u @ p0["wx"], p0["conv_x"]).reshape(b, l, h, hd)
        bb = ssm._causal_conv(u @ p0["wB"], p0["conv_B"])
        cc = ssm._causal_conv(u @ p0["wC"], p0["conv_C"])
        dt = ssm._softplus(u @ p0["wdt"] + p0["dt_bias"])
        a_log = p0["A_log"].clone()
    del params, p0, u
    free()
    cum = (dt * torch.exp(a_log)).reshape(b, l // q, q, h).sum(2)
    ss.reset_launches()
    y = kernels.ssd_chunk_scan(x, dt, a_log, bb, cc, chunk=q)
    torch.cuda.synchronize()
    launches = ss.LAUNCHES["ssd_scan"]
    if launches != 1:
        raise AssertionError(f"ssd_chunk_scan: {launches} launches for 1 "
                             f"call")
    rows = {}
    for dt_ in (torch.float32, torch.bfloat16):
        args = tuple(t.to(dt_) for t in (x, dt)) + (a_log,) + tuple(
            t.to(dt_) for t in (bb, cc))
        tag = f"{MAMBA} layer 0, (B, L, H, P, N) = ({b}, {l}, {h}, {hd}, " \
              f"{n}), chunk {q}, {dt_}"
        got = y if dt_ == torch.float32 else kernels.ssd_chunk_scan(
            *args, chunk=q)
        err, ratio = ssd_close(got, ss.ssd_chunk_scan_ref(*args, chunk=q),
                               tag)
        note = ""
        if dt_ == torch.float32:
            model = ssm.ssd_chunked(x, dt, a_log, bb, cc, q)
            m_err = (got - model).abs().max().item()
            m_tol = 1e-4 * max(1.0, model.abs().max().item())
            if not m_err <= m_tol:
                raise AssertionError(f"ssd_scan {tag}: {m_err:.3e} from the "
                                     f"model's ssd_chunked (limit "
                                     f"{m_tol:.3e})")
            note = (f"; vs the model's ssd_chunked {m_err:.3e} (limit "
                    f"{m_tol:.3e})")
            del model
        free()
        ms = time_ms(lambda: kernels.ssd_chunk_scan(*args, chunk=q), 10,
                     warmup=2)
        plain = time_ms(lambda: ss.ssd_chunk_scan_ref(*args, chunk=q), 3)
        free()
        nbytes, flops, tc = ssd_cost(b, l, h, hd, n, q, dt_.itemsize)
        b_ms, by = bound_ms(nbytes, *tc)
        core_ms, _ = bound_ms(nbytes, flops)
        rows[dt_] = dict(ms=ms, plain=plain, bound=b_ms, by=by,
                         core_bound=core_ms, err=err)
        # the sequential recurrence's count, lower still: per step and
        # head, decay·S + xd ⊗ B (3PN) and S·C (2PN)
        rec_ms = 5 * b * l * h * hd * n / PEAK_FLOPS_FP32 * 1e3
        print(f"[3 kernels] ssd_scan via ssd_chunk_scan at {tag}: {ms:.3f} "
              f"ms; tensor-core bound {b_ms:.3f} ms by {by}, "
              f"{100 * b_ms / ms:.1f}%; fp32 CUDA-core bound {core_ms:.3f} "
              f"ms, {100 * core_ms / ms:.1f}% (the chunked form with C·Bᵀ "
              f"once per batch; the recurrence's count {rec_ms:.3f} ms); "
              f"plain {plain:.3f} ms; "
              f"library: none; max abs "
              f"err vs plain {err:.3e} (max|y| "
              f"{got.float().abs().max().item():.3e}, {ratio:.3f} of the "
              f"tolerance){note}; cum falls by "
              f"{cum.min().item():.1f}-{cum.max().item():.1f} per chunk",
              flush=True)
        del got, args
    del x, dt, bb, cc, y
    free()
    return launches, rows


# --------------------- the two model kernels past the first port's domain
def attention_wide(dev):
    """``kernels.mha_flash`` at the head dims the first port refused
    (ATTN_WIDE: D = 80, 112, 256 and the odd 72), fp32 and bf16, causal
    and window 512: each output against the plain version within the
    tolerance, its time (CUDA events) beside the tensor-core bound counted
    as for the main path (attention_cost at the true D), the plain
    version's and SDPA's (timed only).  Returns rows for the kernels
    line."""
    from repro_torch import kernels
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    rows = []
    for model, shape in ATTN_WIDE.items():
        b, s, h, kvh, d = shape
        base = [torch.randn(b, s, n, d, generator=gen, device=dev)
                for n in (h, kvh, kvh)]
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dt) for x in base)
            for w in ATTN_WINDOWS:
                tag = f"{model} {shape} {dt} window {w}"
                err, past = attention_close(
                    kernels.mha_flash(q, k, v, window=w),
                    fa.mha_flash_ref(q, k, v, window=w), tag)
                free()
                ms = time_ms(lambda: kernels.mha_flash(q, k, v, window=w), 5,
                             warmup=1)
                plain = time_ms(lambda: fa.mha_flash_ref(q, k, v, window=w),
                                2)
                free()
                library = time_ms(sdpa_call(q, k, v, w), 5, warmup=1)
                free()
                nbytes, _, tc = attention_cost(*shape, w, dt.itemsize)
                b_ms, by = bound_ms(nbytes, *tc)
                rows.append(dict(shape=model, d=d, dtype=str(dt)[6:],
                                 window=w, ms=ms, bound_ms=b_ms, err=err,
                                 plain_ms=plain, library_ms=library))
                print(f"[3 kernels] flash_attention via mha_flash at {tag}: "
                      f"{ms:.3f} ms; tensor-core bound {b_ms:.3f} ms by "
                      f"{by}, {100 * b_ms / ms:.1f}%; plain {plain:.3f} ms; "
                      f"SDPA ({str(dt)[6:]}) {library:.3f} ms; max abs err "
                      f"vs plain {err:.3e}"
                      + (f" ({past} elements one bf16 ulp apart)"
                         if dt == torch.bfloat16 else ""), flush=True)
        del base, q, k, v
        free()
    return rows


def ssd_wide(dev):
    """``kernels.ssd_chunk_scan`` at the (P, N) the first port refused
    (SSD_WIDE), fp32 and bf16: each output against the plain version
    within the tolerance, its time beside the tensor-core bound (ssd_cost)
    and the plain version's; first the host-side shared-memory count that the wrappers' predicate
    reads (``ssd_scan.smem_bytes``) against the source's own.  Returns
    rows for the kernels line."""
    from repro_torch import kernels
    from repro_torch.kernels import ssd_scan as ss
    lib = ss._lib()
    n_counts = 0
    for p in (16, 64, 100, 128):
        for n in (8, 128, 200, 256):
            for q in (64, 256, 2474, 4096):
                for xb in (0, 1):
                    for bcb in (0, 1):
                        want = lib.ssd_scan_smem_bytes(p, n, q, xb, bcb)
                        got = ss.smem_bytes(p, n, q, 2 if xb else 4,
                                            2 if bcb else 4)
                        if got != want:
                            raise AssertionError(
                                f"ssd_scan.smem_bytes{(p, n, q, xb, bcb)} "
                                f"= {got}, the source's {want}")
                        n_counts += 1
    print(f"[3 kernels] ssd_scan: the predicate's shared-memory count "
          f"equals the source's at {n_counts} (P, N, chunk, dtypes)",
          flush=True)
    rows = []
    for i, (name, (b, l, h, p, n, q)) in enumerate(SSD_WIDE.items()):
        for dt in (torch.float32, torch.bfloat16):
            args = ssd_inputs(40 + i, b, l, h, p, n, dev, dt)
            tag = f"{name}, (B, L, H, P, N) = ({b}, {l}, {h}, {p}, {n}), " \
                  f"chunk {q}, {dt}"
            err, ratio = ssd_close(kernels.ssd_chunk_scan(*args, chunk=q),
                                   ss.ssd_chunk_scan_ref(*args, chunk=q), tag)
            free()
            ms = time_ms(lambda: kernels.ssd_chunk_scan(*args, chunk=q), 5,
                         warmup=1)
            plain = time_ms(lambda: ss.ssd_chunk_scan_ref(*args, chunk=q), 2)
            free()
            nbytes, _, tc = ssd_cost(b, l, h, p, n, q, dt.itemsize)
            b_ms, by = bound_ms(nbytes, *tc)
            rows.append(dict(shape=name, p=p, n=n, dtype=str(dt)[6:], ms=ms,
                             bound_ms=b_ms, err=err, plain_ms=plain))
            print(f"[3 kernels] ssd_scan via ssd_chunk_scan at {tag}: "
                  f"{ms:.3f} ms; tensor-core bound {b_ms:.3f} ms by {by}, "
                  f"{100 * b_ms / ms:.1f}%; plain {plain:.3f} ms; library: "
                  f"none; max abs err vs plain {err:.3e} ({ratio:.3f} of "
                  f"the tolerance)", flush=True)
            del args
            free()
    return rows


# --------------------------------------------------- the serving path
def decode_consistency(eng, out, s):
    """Decode ``out``'s tokens after the prompt (teacher-forced) and hold
    each step's logits against ``prefill`` of the same prefix at its last
    position.  Returns (largest |decode − prefill| / max|prefill logit|,
    every logit finite, the greedy tokens the decode logits give where
    their top-2 margin exceeds the tolerance, else None)."""
    logits, cache = eng.prefill(out[:, :s])
    finite = bool(torch.isfinite(logits).all())
    worst, picks = 0.0, []
    for i in range(out.shape[1] - s - 1):
        pos = s + i
        dl, cache = eng.step(cache, out[:, pos:pos + 1], pos)
        pl, _ = eng.prefill(out[:, :pos + 1])
        finite &= bool(torch.isfinite(dl).all() & torch.isfinite(pl).all())
        scale = pl.abs().max().item()
        worst = max(worst, (dl - pl).abs().max().item() / scale)
        top2 = torch.topk(dl[:, 0], 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * SERVE_REL_TOL * scale
        picks.append(torch.where(sure, torch.argmax(dl[:, 0], dim=-1), -1))
    return worst, finite, torch.stack(picks, dim=1)


def serve_path(tag, arch, vu, fa, ss, args=SERVE_ARGS, phase="4 main path",
               card=None):
    """Paths (s), (t), (v), (aa), (ab): ``repro_torch.launch.serve`` at
    full width (``args``: batch, prompt and generated tokens; random
    weights from seed 0): no kernel launched (the reference's serving path
    runs none); then ``served_checks``."""
    from repro_torch.launch import serve
    for mod in (vu, fa, ss):
        mod.reset_launches()
    res = serve.run(["--arch", arch] + args)
    launches = {**vu.LAUNCHES, **fa.LAUNCHES, **ss.LAUNCHES}
    check_launches(tag, launches, {})
    row = served_checks(tag, arch, res.cfg, res.engine, res.prompt, res.out,
                        res.prefill_ms, res.decode_ms, res.wall_s,
                        res.peak_bytes, phase, card)
    del res
    free()
    return row


def attention_tree(params) -> dict:
    """The stacked attention leaves of a model's tree (the hybrid's under
    its block)."""
    layers = params["layers"]
    return layers["hyb"]["attn"] if "hyb" in layers else layers["attn"]


def served_checks(tag, label, cfg, eng, prompt, out, prefill_ms, decode_ms,
                  wall_s, peak, phase="4 main path", card=None):
    """The checks of a served path on the engine that served it
    (``eng.prefill``, ``eng.step``): the output's shape and its prompt;
    for token ids every token in [0, V) and the greedy tokens the decode
    logits give (where their top-2 margin is clear); every prefill and
    decode logit finite; the tree's parameter count; decode against
    prefill of the same prefix within SERVE_REL_TOL · max|logit|.  The
    attention models are held with wq and wk × 0.1 (in place, no second
    copy of the tree): under the reference's own init their attention
    scores grow with depth until the softmax is near one-hot, and two
    summation orders of the same logits part (the reference's JAX prefill
    and decode at 24 layers, d 128, differ by more than 1e-2 ·
    max|logit|, tests/test_torch_serve.py; the port's on the card: printed
    as measured, not held), as in ROADMAP Queue 3.  The attention-free
    ssm family (v) is held under the init as drawn.  ``out`` holds frame
    embeddings (B, S + gen, F) for the codec frontend, its prompt the
    first S."""
    b, s = prompt.shape[:2]
    gen = out.shape[1] - s
    codec = cfg.frontend == "codec"
    if out.shape[:2] != (b, s + gen) or not torch.equal(out[:, :s], prompt):
        raise AssertionError(f"path {tag}: output {tuple(out.shape)}")
    v = cfg.vocab_size
    if not codec and (int(out.min()) < 0 or int(out.max()) >= v):
        raise AssertionError(f"path {tag}: a token outside [0, {v})")
    n_params = sum(x.numel() for x in tm_leaves(eng.params))
    # param_count leaves out the final norm, as the reference's does (and
    # the codec frontend's frontend_proj); for the ssm and hybrid families
    # it is the reference's analytic overcount
    want_n = {"ssm": MAMBA_PARAMS, "hybrid": HYMBA_PARAMS}.get(
        cfg.family, cfg.param_count() + cfg.d_model
        + (cfg.frontend_dim * cfg.d_model if codec else 0))
    if n_params != want_n:
        raise AssertionError(f"path {tag}: {n_params} parameters")
    raw, finite, picks = decode_consistency(eng, out, s)
    if not finite:
        raise AssertionError(f"path {tag}: a non-finite logit")
    rederived = ""
    if not codec:
        want = out[:, s + 1:]
        off = int(((picks >= 0) & (picks != want)).sum())
        if off:
            raise AssertionError(f"path {tag}: {off} greedy tokens differ "
                                 f"from the decode logits' clear picks")
        rederived = f"; {int((picks >= 0).sum())} greedy tokens re-derived"
    if cfg.family == "ssm":
        soft = raw
        held = f"{raw:.3e} · max|logit| under the init as drawn"
    else:
        attn = attention_tree(eng.params)
        attn["wq"].mul_(0.1)
        attn["wk"].mul_(0.1)
        soft, finite, _ = decode_consistency(eng, out, s)
        held = (f"{soft:.3e} · max|logit| with wq, wk × 0.1, {raw:.3e} "
                f"under the init as drawn (not held)")
        del attn
    if not finite or soft > SERVE_REL_TOL:
        raise AssertionError(f"path {tag}: decode vs prefill "
                             f"{soft:.3e} · max|logit| (limit "
                             f"{SERVE_REL_TOL}), finite {finite}")
    per_tok = float(np.mean(decode_ms))
    nbytes = sum(x.numel() * x.element_size() for x in tm_leaves(eng.params))
    weights_ms = 1e3 * nbytes / HBM_BW
    row = dict(tag=tag, prefill_ms=prefill_ms, decode_ms=per_tok,
               tok_s=b * gen / wall_s, peak_gib=peak / 2 ** 30,
               weights_ms=weights_ms, launches={})
    unit = "frame" if codec else "token"
    print(f"[{phase} {tag}] {label}, {n_params} parameters, batch {b}: "
          f"prefill {prefill_ms:.3f} ms ({b} x {s} {unit}s), decode "
          f"{per_tok:.3f} ms per {unit} ({len(decode_ms)} steps, "
          f"{min(decode_ms):.3f}-{max(decode_ms):.3f}; the weights' "
          f"{nbytes / 1e9:.2f} GB take {weights_ms:.3f} ms at 3.35 TB/s), "
          f"{row['tok_s']:.1f} {unit}s/s batched, peak "
          f"{row['peak_gib']:.2f} GiB; no kernel launched{rederived}; "
          f"decode vs prefill of the same prefix {held} (limit "
          f"{SERVE_REL_TOL})" + (f"; {card}" if card else ""), flush=True)
    return row


def serve_small_input(dev) -> None:
    """Phase 5 for the serving path: the smoke models (qwen2-0.5b and
    granite-3-2b, 2 layers) on the card and on the CPU from the same
    parameters (wq, wk × 0.1): prefill logits and the cache leaf by leaf,
    decode logits over the CPU's greedy tokens, and the greedy tokens where
    the CPU's top-2 margin exceeds twice the tolerance, full attention and
    a window of 8 (ring buffer); then mha_flash at the smoke model's
    attention shapes, the kernel on the card against the CPU."""
    from repro_torch import kernels
    from repro_torch import tree as tm
    from repro_torch.configs import registry
    from repro_torch.models import transformer
    from repro_torch.serve import Engine
    tol = 1e-4
    notes = []
    for arch in ("qwen2-0.5b", "granite-3-2b"):
        cfg = registry.smoke_arch(arch)
        params = transformer.init_params(cfg, seed=0)
        attn = params["layers"]["attn"]
        attn["wq"], attn["wk"] = attn["wq"] * 0.1, attn["wk"] * 0.1
        on_card = tm.tree_map(lambda x: x.to(dev), params)
        gen = torch.Generator()
        gen.manual_seed(4)
        prompt = torch.randint(0, cfg.vocab_size, (3, 12), generator=gen)
        for window in (None, 8):
            tag = f"{arch} smoke, window {window}"
            with torch.no_grad():
                lc, cc = transformer.prefill(cfg, params, prompt, 32,
                                             window=window)
                lg, cg = transformer.prefill(cfg, on_card, prompt.to(dev),
                                             32, window=window)
            close(lg.cpu(), lc, tol, f"{tag}: prefill logits")
            for key in cc:
                close(cg[key].cpu(), cc[key],
                      tol * max(1.0, cc[key].abs().max().item()),
                      f"{tag}: prefill cache {key}")
            cpu, card = (Engine(cfg, p, max_len=32, window=window)
                         for p in (params, on_card))
            want = cpu.generate(prompt, 16)
            got = card.generate(prompt, 16).cpu()
            # the CPU's tokens, teacher-forced through both
            _, c_cpu = cpu.prefill(prompt)
            _, c_card = card.prefill(prompt)
            for i in range(15):
                pos = 12 + i
                tok = want[:, pos:pos + 1]
                l_cpu, c_cpu = cpu.step(c_cpu, tok, pos)
                l_card, c_card = card.step(c_card, tok, pos)
                close(l_card.cpu(), l_cpu, tol, f"{tag}: decode logits at "
                      f"{pos}")
            margins = decode_margins(cpu, want, 12)
            compared = 0
            for row in range(3):
                for i in range(16):
                    if margins[row, i] <= 2 * tol:
                        break           # either pick is right; they part
                    if got[row, 12 + i] != want[row, 12 + i]:
                        raise AssertionError(f"{tag}: greedy token {i} of "
                                             f"row {row} differs")
                    compared += 1
            notes.append(f"{tag}: {compared} greedy tokens equal")
    rng = np.random.RandomState(6)
    cfg = registry.smoke_arch("qwen2-0.5b")
    for s in (12, 28):
        q, k, v = (torch.from_numpy(rng.randn(
            3, s, n, cfg.head_dim).astype(np.float32)) for n in (
                cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads))
        for window in (None, 8):
            want = kernels.mha_flash(q, k, v, window=window)
            got = kernels.mha_flash(q.to(dev), k.to(dev), v.to(dev),
                                    window=window).cpu()
            attention_close(got, want, f"smoke (3, {s}, {cfg.num_heads}, "
                            f"{cfg.num_kv_heads}, {cfg.head_dim}) window "
                            f"{window}, card vs CPU")
    print(f"[5 small input] serving card vs CPU: prefill logits and cache, "
          f"decode logits (atol {tol}), {'; '.join(notes)}; mha_flash at "
          f"the smoke model's shapes within rtol 2e-4, atol 2e-5 of the "
          f"CPU", flush=True)


def ssm_small_input(dev) -> None:
    """Phase 5 for the ssm family: the smoke mamba2-370m (2 layers, d 128,
    4 SSD heads of 32, state 16, chunk 32) on the card and on the CPU from
    the same parameters: prefill logits and both cache leaves (the SSM
    state, the conv window) over 40 tokens (a full chunk and a padded one),
    decode over the CPU's greedy tokens (atol 1e-4) and the greedy tokens
    where the CPU's top-2 margin exceeds twice that; one vrl_sgd + sgd
    slice, W = 2, seq 40, 7 steps in rounds of 1, 2, 2, 2 (losses rtol
    1e-4, params atol 1e-4, Δ atol 1e-4/(k γ)); and ssd_chunk_scan at the
    smoke model's shapes, the kernel against the CPU's plain version."""
    from repro_torch import kernels
    from repro_torch import tree as tm
    from repro_torch.configs import registry
    from repro_torch.configs.base import VRLConfig
    from repro_torch.data import assigned_token_stream, contiguous_assignment
    from repro_torch.models import transformer
    from repro_torch.serve import Engine
    from repro_torch.train.train_loop import make_train_step
    tol = 1e-4
    cfg = registry.smoke_arch(MAMBA)
    params = transformer.init_params(cfg, seed=0)
    on_card = tm.tree_map(lambda x: x.to(dev), params)
    gen = torch.Generator()
    gen.manual_seed(4)
    prompt = torch.randint(0, cfg.vocab_size, (3, 40), generator=gen)
    tag = f"{MAMBA} smoke"
    with torch.no_grad():
        lc, cc = transformer.prefill(cfg, params, prompt, 64)
        lg, cg = transformer.prefill(cfg, on_card, prompt.to(dev), 64)
    close(lg.cpu(), lc, tol, f"{tag}: prefill logits")
    for key in cc:
        close(cg[key].cpu(), cc[key],
              tol * max(1.0, cc[key].abs().max().item()),
              f"{tag}: prefill cache {key}")
    cpu, card = (Engine(cfg, p, max_len=64) for p in (params, on_card))
    want = cpu.generate(prompt, 16)
    got = card.generate(prompt, 16).cpu()
    _, c_cpu = cpu.prefill(prompt)
    _, c_card = card.prefill(prompt)
    for i in range(15):
        pos = 40 + i
        tok = want[:, pos:pos + 1]
        l_cpu, c_cpu = cpu.step(c_cpu, tok, pos)
        l_card, c_card = card.step(c_card, tok, pos)
        close(l_card.cpu(), l_cpu, tol, f"{tag}: decode logits at {pos}")
    margins = decode_margins(cpu, want, 40)
    compared = 0
    for row in range(3):
        for i in range(16):
            if margins[row, i] <= 2 * tol:
                break                   # either pick is right; they part
            if got[row, 40 + i] != want[row, 40 + i]:
                raise AssertionError(f"{tag}: greedy token {i} of row "
                                     f"{row} differs")
            compared += 1
    w, k, lr, steps = 2, 2, LR, 7
    data = assigned_token_stream(contiguous_assignment(w, w), 40,
                                 cfg.vocab_size, steps=steps, batch=2,
                                 alpha=0.05, seed=0)
    vrl = VRLConfig(comm_period=k, learning_rate=lr, warmup=True)
    runs = {}
    for where in ("cpu", dev):
        bundle = make_train_step(cfg, vrl, device=where)
        state = bundle.engine.init(tm.tree_map(lambda x: x.to(where),
                                               params), w)
        losses, t = [], 0
        for rk in (1, k, k, k):
            toks = torch.from_numpy(data[t:t + rk]).to(where).long()
            state, lk = bundle.round_step(state, toks,
                                          torch.roll(toks, -1, dims=-1))
            losses += lk.tolist()
            t += rk
        runs[str(where)] = (np.array(losses), state.params.cpu().numpy(),
                            state.delta.cpu().numpy())
    (l_c, p_c, d_c), (l_g, p_g, d_g) = runs["cpu"], runs[str(dev)]
    np.testing.assert_allclose(l_g, l_c, rtol=1e-4)
    np.testing.assert_allclose(p_g, p_c, rtol=0, atol=1e-4)
    np.testing.assert_allclose(d_g, d_c, rtol=0, atol=1e-4 / (k * lr))
    rng = np.random.RandomState(8)
    h, hd, n = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state
    x, dt = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.randn(3, 40, h, hd), np.log1p(np.exp(rng.randn(3, 40, h)))))
    a_log = torch.from_numpy((rng.randn(h) * 0.5).astype(np.float32))
    bb, cc_ = (torch.from_numpy((rng.randn(3, 40, n) * 0.3).astype(
        np.float32)) for _ in range(2))
    want_y = kernels.ssd_chunk_scan(x, dt, a_log, bb, cc_,
                                    chunk=cfg.ssm_chunk)
    got_y = kernels.ssd_chunk_scan(*(t.to(dev) for t in (x, dt, a_log, bb,
                                                         cc_)),
                                   chunk=cfg.ssm_chunk).cpu()
    err, _ = ssd_close(got_y, want_y, f"smoke (3, 40, {h}, {hd}, {n}), card "
                       f"vs CPU")
    print(f"[5 small input] {tag} card vs CPU: prefill logits and cache "
          f"(state, conv), decode logits over 15 steps (atol {tol}), "
          f"{compared} greedy tokens equal; vrl_sgd+sgd 7 steps: losses max "
          f"rel diff {np.abs(l_g / l_c - 1).max():.2e}, params max diff "
          f"{np.abs(p_g - p_c).max():.2e}, Δ max diff "
          f"{np.abs(d_g - d_c).max():.2e}; ssd_chunk_scan at the smoke "
          f"shape within the tolerance (max abs err {err:.3e})",
          flush=True)


def decode_margins(eng, out, s) -> np.ndarray:
    """The top-2 margin of the logits behind each generated token of
    ``out`` (B, s + n): the prefill's last position, then each decode
    step's."""
    logits, cache = eng.prefill(out[:, :s])
    margins = []
    for i in range(out.shape[1] - s):
        top2 = torch.topk(logits[:, -1], 2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
        if s + i + 1 < out.shape[1]:
            logits, cache = eng.step(cache, out[:, s + i:s + i + 1], s + i)
    return np.stack(margins, axis=1)


def close(got, want, atol, tag) -> None:
    err = (got.float() - want.float()).abs().max().item()
    if got.shape != want.shape or got.dtype != want.dtype or err > atol:
        raise AssertionError(f"{tag}: max abs err {err:.3e} (atol {atol}); "
                             f"{got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")


def _delta_tree(eng, state):
    """The flat engine's Δ as a worker-stacked tree (views)."""
    from repro_torch.core import flat
    return flat.unflatten_stacked(eng.spec, state.delta)


# --------------------------------------------- 6 the paper's workload
def paper_cpu_runs(path: str) -> int:
    """The child process of phase 6: every figure's runs on the CPU
    (``paper.figures``, the per-leaf executor, the reference's own), each
    run's per-step losses (Appendix E: its distance) written as JSON to
    ``path``, keyed by figure and repr(run key).  Started before phase 4,
    so it runs beside the card's paths."""
    from repro_torch.paper import figures
    torch.set_num_threads(3)
    out = {}
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        for name, fn in figures.FIGURES.items():
            rec = {}
            fn(device="cpu", backend="reference", record=rec)
            out[name] = {repr(k): v for k, v in rec.items()}
    out["seconds"] = time.time() - START
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def start_paper_cpu():
    """Start ``paper_cpu_runs`` in a child process: (process, its JSON
    path, its log path)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_paper_")
    path, log = os.path.join(tmp, "cpu.json"), os.path.join(tmp, "cpu.log")
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--paper-cpu", path],
            stdout=subprocess.DEVNULL, stderr=err, cwd=ROOT)
    return proc, path, log


def paper_cpu_result(proc, path, log, what="the paper's CPU runs") -> dict:
    """Wait for the child (at most 600 s) and read its runs."""
    rc = proc.wait(timeout=600)
    if rc != 0:
        with open(log) as f:
            raise AssertionError(f"{what} failed ({rc}): "
                                 f"{f.read()[-3000:]}")
    with open(path) as f:
        return json.load(f)


def paper_close(got, want, tag) -> float:
    """Per-step losses (or Appendix E's distances) within PAPER_ATOL +
    PAPER_RTOL · |want|, all finite; returns the max abs difference."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if g.shape != w.shape or not np.isfinite(g).all():
        raise AssertionError(f"paper {tag}: {g.shape} vs {w.shape}, or not "
                             f"finite")
    err = np.abs(g - w)
    bad = err > PAPER_ATOL + PAPER_RTOL * np.abs(w)
    if bad.any():
        i = int(np.argmax(bad.ravel()))
        raise AssertionError(f"paper {tag}: {int(bad.sum())} values past "
                             f"atol {PAPER_ATOL} + rtol {PAPER_RTOL} (first "
                             f"at {i}: {g.ravel()[i]} vs {w.ravel()[i]})")
    return float(err.max())


def paper_launches(alg, steps, k, warmup=False) -> dict:
    """The flat engine's launches that the schedule gives a run: one
    fused_local_sgd a step, one sync kernel a round (rounds of k steps,
    the warm-up's first of one step)."""
    want = {"fused_local_sgd": steps}
    if PAPER_SYNC[alg]:
        want[PAPER_SYNC[alg]] = (1 + (steps - 1) // k if warmup
                                 else steps // k)
    return want


def paper_check_launches(tag, vu, want) -> dict:
    got = {n: c for n, c in vu.LAUNCHES.items() if c}
    if got != want:
        raise AssertionError(f"paper {tag}: launches {got}, the schedule's "
                             f"{want}")
    return got


def paper_sums(w, lr):
    """An ``on_step`` hook recording Σ_i Δ_i after each sync against the
    bound of check_sums: 1e-4 · max|Δ| plus 2 W ulp(max|p|)/(k_eff γ)
    summed over the syncs."""
    from repro_torch.core import engine
    seen = []

    def hook(step, state):
        if state.last_sync != step:
            return
        k_eff = step - (seen[-1]["step"] if seen else 0)
        s, m = engine.sum_invariant(state.delta)
        max_p = state.params.abs().max().item()
        rounding = 2 * w * float(np.spacing(np.float32(max_p))) / (
            k_eff * lr)
        prev = seen[-1]["rounding"] if seen else 0.0
        seen.append(dict(step=step, sum=s, max=m,
                         rounding=prev + rounding))
        limit = 1e-4 * max(r["max"] for r in seen) + seen[-1]["rounding"]
        if not s <= limit:
            raise AssertionError(f"paper: Σ_i Δ_i = {s} after the sync at "
                                 f"step {step}, past {limit}")
    return hook, seen


def paper_fig1(dev, vu, cpu, card):
    """Path (w): Fig. 1 at ``run_mlp_task``'s defaults (W = 8, batch 32,
    γ = 0.5, k = 20, 300 steps, class-sharded features (4096, 256), 64
    classes, hidden 128) on the card, each algorithm through the flat
    engine's kernels and through the per-leaf executor: per-step losses
    within the bound of each other and of the CPU's run from the same
    initial tree; the fused run's launches those of the schedule, Σ_i Δ_i
    ≈ 0 after each of VRL-SGD's syncs; VRL-SGD's gap to S-SGD below Local
    SGD's.  Returns the fused runs' launches."""
    from repro_torch.data import feature_classification
    from repro_torch.paper import task
    data = feature_classification(n=4096, dim=256, num_classes=64, seed=0)
    final, first_launches = {}, {}
    for alg in PAPER_ALGS:
        runs, ms, seen = {}, {}, []
        for backend in ("fused", "reference"):
            hook = None
            if backend == "fused" and alg == "vrl_sgd":
                hook, seen = paper_sums(8, 0.5)
            vu.reset_launches()
            t0 = time.perf_counter()
            run = task.mlp_task(alg, device=dev, update_backend=backend,
                                data=data, on_step=hook)
            ms[backend] = (time.perf_counter() - t0) / 300 * 1e3
            runs[backend] = run.losses
            want = (paper_launches(alg, 300, 20) if backend == "fused"
                    else {})
            got = paper_check_launches(f"(w) {alg} {backend}", vu, want)
            if backend == "fused":
                first_launches.update(got)
        tag = f"(w) fig1 {alg}"
        e_fr = paper_close(runs["fused"], runs["reference"],
                           f"{tag}: fused vs reference")
        ref_cpu = cpu["fig1"][repr(alg)]
        e_fc = paper_close(runs["fused"], ref_cpu, f"{tag}: fused vs CPU")
        e_rc = paper_close(runs["reference"], ref_cpu,
                           f"{tag}: reference vs CPU")
        final[alg] = float(np.mean(runs["fused"][-20:]))
        note = ""
        if seen:
            note = (f"; Σ_i Δ_i after each of its {len(seen)} syncs ≤ "
                    f"{max(r['sum'] for r in seen):.3e} (max|Δ| "
                    f"{max(r['max'] for r in seen):.3e})")
        print(f"[6 paper {tag}] final loss (mean of the last 20) "
              f"{final[alg]:.6f}; per-step losses: fused vs reference "
              f"{e_fr:.3e}, fused vs CPU {e_fc:.3e}, reference vs CPU "
              f"{e_rc:.3e} (bound {PAPER_ATOL} + {PAPER_RTOL}·|loss|); "
              f"launches {paper_launches(alg, 300, 20)}; host ms per step: "
              f"fused {ms['fused']:.3f}, reference {ms['reference']:.3f}"
              f"{note}; {card}", flush=True)
    gap_vrl = final["vrl_sgd"] - final["ssgd"]
    gap_loc = final["local_sgd"] - final["ssgd"]
    if not gap_vrl < gap_loc:
        raise AssertionError(f"paper (w): vrl_gap_to_ssgd {gap_vrl} not "
                             f"below local_gap_to_ssgd {gap_loc}")
    print(f"[6 paper (w) fig1] vrl_gap_to_ssgd={gap_vrl:.4f};"
          f"local_gap_to_ssgd={gap_loc:.4f};vrl_beats_local="
          f"{final['vrl_sgd'] < final['local_sgd']}", flush=True)
    return first_launches


def paper_figures(dev, cpu, card):
    """Path (x): Fig. 2, the warm-up ablation, Appendix E and Appendix F
    on the card through the flat engine's kernels (``paper.figures``,
    ``backend="fused"``): each run within the bound of the CPU's, and the
    conclusions the reference's own runs show (Fig. 2's core spread below
    0.005; the warm-up's early gain positive; Appendix E's VRL-SGD within
    1e-3 of x* at every (b, k) and Local SGD's bias growing; Appendix F's
    VRL-SGD degrading less than Local SGD from k = 2 to k = 100)."""
    from repro_torch.paper import figures
    results = {}
    for name in ("fig2", "warmup", "appendix_e", "appendix_f"):
        rec = {}
        t0 = time.perf_counter()
        with open(os.devnull, "w") as sink, \
                contextlib.redirect_stdout(sink):
            results[name] = figures.FIGURES[name](device=dev, backend="fused",
                                                  record=rec)
        wall = time.perf_counter() - t0
        worst = max(paper_close(v, cpu[name][repr(key)], f"(x) {name} {key}")
                    for key, v in rec.items())
        print(f"[6 paper (x) {name}] {len(rec)} runs on the card within the "
              f"bound of the CPU's (max abs diff {worst:.3e}) in {wall:.1f} s",
              flush=True)
    out = results["fig2"]
    core = [out[a] for a in ("ssgd", "vrl_sgd", "local_sgd")]
    spread = max(core) - min(core)
    out = results["warmup"]
    gain = out["vrl_sgd"][0] - out["vrl_sgd_w"][0]
    out = results["appendix_e"]
    bs, ks = (1.0, 5.0, 25.0), (4, 16, 64)
    vrl_worst = max(out[("vrl_sgd", b, k)] for b in bs for k in ks)
    grows = out[("local_sgd", 25.0, 64)] > out[("local_sgd", 1.0, 4)]
    out = results["appendix_f"]
    deg_vrl = out[("vrl_sgd", 100)] - out[("vrl_sgd", 2)]
    deg_loc = out[("local_sgd", 100)] - out[("local_sgd", 2)]
    print(f"[6 paper (x)] fig2 final_loss_spread_core={spread:.4f} "
          f"(easgd {results['fig2']['easgd']:.4f}); warmup_early_gain="
          f"{gain:.4f}; appendix_e max VRL-SGD distance {vrl_worst:.3e}, "
          f"local_bias_grows={grows}; appendix_f vrl_degradation="
          f"{deg_vrl:.4f}, local_degradation={deg_loc:.4f}; {card}",
          flush=True)
    if not (spread < 0.005 and gain > 0 and vrl_worst < 1e-3 and grows
            and deg_vrl < deg_loc):
        raise AssertionError("paper (x): a conclusion of the reference's "
                             "runs does not hold on the card")


def paper_width(dev, vu, card):
    """Path (y): the paper's width, ``configs.paper_mlp`` (2048 -> 1024 ->
    200) over ``feature_classification()`` at its defaults (n 8192, dim
    2048, 200 classes), W = 8, batch 32, k = 20, 300 steps, each algorithm
    through the flat engine's kernels: ms per step on the host clock
    (synchronised; the loader and the per-step loss read included), the
    engine's device ms per round (k local steps and the sync on the run's
    final state and one fixed gradient buffer, CUDA events), launches,
    peak memory and the final losses.  Recorded, no time asserted."""
    from repro_torch.configs.paper_mlp import CONFIG
    from repro_torch.data import feature_classification
    from repro_torch.paper import task
    data = feature_classification()
    if (data.x.shape[1], data.num_classes) != (CONFIG.in_dim,
                                                CONFIG.classes):
        raise AssertionError(f"paper (y): data {data.x.shape}, "
                             f"{data.num_classes} classes, not {CONFIG}")
    k, steps = 20, 300
    for alg in PAPER_ALGS:
        free()
        torch.cuda.reset_peak_memory_stats(dev)
        vu.reset_launches()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        run = task.mlp_task(alg, device=dev, update_backend="fused",
                            data=data, hidden=CONFIG.hidden, k=k,
                            steps=steps)
        torch.cuda.synchronize(dev)
        ms_step = (time.perf_counter() - t0) / steps * 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        launches = paper_check_launches(f"(y) {alg}", vu,
                                        paper_launches(alg, steps, k))
        if not np.isfinite(run.losses).all():
            raise AssertionError(f"paper (y) {alg}: a loss is not finite")
        eng, state = run.executor, run.state
        gen = torch.Generator(device=dev)
        gen.manual_seed(6)
        g = torch.randn(state.params.shape, generator=gen, device=dev) * 1e-3

        def one_round():
            s = state
            for _ in range(k):
                s = eng.local_step(s, g)
            eng.sync(s)

        round_ms = time_ms(one_round, 3, warmup=1)
        print(f"[6 paper (y) {CONFIG.name} {alg}] W 8, batch 32, k {k}, "
              f"{steps} steps, {eng.spec.rows} x {eng.spec.lanes} flat rows "
              f"a worker: {ms_step:.3f} ms per step (host clock); engine "
              f"{round_ms:.3f} ms per round of {k} local steps and the sync "
              f"(CUDA events); launches {launches}; peak "
              f"{peak / 2 ** 30:.3f} GiB; final loss (mean of the last 20) "
              f"{float(np.mean(run.losses[-20:])):.6f}, first "
              f"{run.losses[0]:.6f}, last {run.losses[-1]:.6f}; {card}",
              flush=True)
        del run, eng, state, g
    free()


# ----------------------------------------------------------------- phase 7
def start_ranks(argv, nproc, out, log, device="cuda"):
    """``launch.train`` under ``python -m torch.distributed.run
    --standalone --nproc-per-node nproc`` with ``--mesh-grid`` and
    ``--loss-out out`` (one JSON per rank), its output into ``log``; its
    own session, so that ``stop_ranks`` reaches every rank."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with open(log, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(nproc), "-m", "repro_torch.launch.train",
             *argv, "--device", device, "--mesh-grid", "--loss-out", out],
            stdout=f, stderr=subprocess.STDOUT, cwd=ROOT, env=env,
            start_new_session=True)


def stop_ranks(proc) -> None:
    """Kill the launcher and its ranks if they still run."""
    if proc.poll() is None:
        os.killpg(proc.pid, 9)
        proc.wait()


def ranks_result(tag, proc, out, log, nproc, timeout=Z_TIMEOUT) -> list:
    """Wait for a launch (at most ``timeout`` s) and read every rank's
    JSON; a non-zero exit or a timeout fails the path."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        stop_ranks(proc)
        rc = "timeout"
    with open(log) as f:
        text = f.read()
    if rc != 0:
        raise AssertionError(f"path {tag}: the ranks exited {rc}: "
                             f"{text[-4000:]}")
    return [dict(json.load(open(f"{out}.rank{r}")), log=text)
            for r in range(nproc)]


def z_launch(argv, nproc):
    """Start one phase-7 launch -> (process, JSON path, log path)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    out, log = os.path.join(tmp, "out.json"), os.path.join(tmp, "log.txt")
    return start_ranks(argv, nproc, out, log), out, log


def z_path(tag, argv, nproc, backend, want_state, want_launches, ref,
           grid=None, lr=MAIN_LR, launch=None):
    """One phase-7 path on the card: the CLI under the launcher, each
    rank's JSON checked — its backend and device, every loss finite and
    the same on every rank, within ``Z_RTOL`` of ``ref`` (the same flags
    as one process: {"losses", "avg"}), the model-state all-reduces per
    group ({group: (calls, async calls)}: one per round, per level in the
    hierarchy, none in the local steps), the kernel launches (each rank's
    own block), the deadline misses where ``ref`` has them, Σ Δ as phase 4
    holds it — and each rank's counts, spans, peak and wall printed.
    ``launch``: the ``z_launch`` of ``argv`` started earlier, or None to
    start it here."""
    ranks = ranks_result(tag, *(launch or z_launch(argv, nproc)), nproc)
    banner = next(line for line in ranks[0]["log"].splitlines()
                  if line.startswith("mesh: "))
    via = {"nccl": "NCCL world 1", "gloo": "gloo through host memory"}[
        backend]
    print(f"[7 mesh {tag}] {banner}", flush=True)
    for r, res in enumerate(ranks):
        if (res["backend"], res["device"]) != (backend, "cuda:0"):
            raise AssertionError(f"path {tag}: rank {r} ran {res['backend']}"
                                 f" on {res['device']}")
        if not all(math.isfinite(x) for x in res["losses"]
                   + res["avg_model_losses"]):
            raise AssertionError(f"path {tag}: rank {r} non-finite loss "
                                 f"{res['losses']}")
        if (res["losses"], res["avg_model_losses"]) != (
                ranks[0]["losses"], ranks[0]["avg_model_losses"]):
            raise AssertionError(f"path {tag}: the ranks' losses differ")
        state = {g: (c["calls"], c["async"])
                 for g, c in res["collectives"]["state"].items()}
        if state != want_state:
            raise AssertionError(f"path {tag}: rank {r} model-state "
                                 f"all-reduces {state}, expected "
                                 f"{want_state}")
        check_launches(f"{tag} rank {r}", res["kernels"], want_launches)
        spans = {k: [round(x, 3) for x in v]
                 for k, v in res["phases_ms"].items() if k != "fwd_bwd"}
        print(f"[7 mesh {tag}] rank {r}: collectives "
              f"{json.dumps(res['collectives'])}; spans ({via}, device ms "
              f"per round) {spans}; round peak "
              f"{res['round_peak_bytes'] / 2**30:.2f} GiB; step wall "
              f"{1e3 * res['wall_s'] / len(res['losses']):.1f} ms",
              flush=True)
    res = ranks[0]
    worst = 0.0
    for got, want in ((res["losses"], ref["losses"]),
                      (res["avg_model_losses"], ref["avg"])):
        if len(got) != len(want):
            raise AssertionError(f"path {tag}: {len(got)} losses, the "
                                 f"one-process run {len(want)}")
        for g, w in zip(got, want):
            rel = abs(g - w) / abs(w)
            worst = max(worst, rel)
            if rel > Z_RTOL:
                raise AssertionError(f"path {tag}: loss {g} vs {w} of the "
                                     f"one-process run (rel {rel:.3e})")
    if "misses" in ref and res["misses"] != ref["misses"]:
        raise AssertionError(f"path {tag}: misses {res['misses']}, the "
                             f"reference run's {ref['misses']}")
    if grid is not None:
        note = hier_sums(tag, types.SimpleNamespace(**res), grid, lr)
    else:
        _, sum_d, _ = res["invariant"][-1]
        max_d = max(m for _, _, m in res["invariant"])
        if not (max_d > 0 and sum_d <= 1e-4 * max_d):
            raise AssertionError(f"path {tag}: Σ_i Δ_i not ~0 after the "
                                 f"last sync: {sum_d} vs max|Δ| {max_d}")
        note = f"max|ΣΔ| {sum_d:.3e} <= 1e-4 * max|Δ| {max_d:.3e}"
    print(f"[7 mesh {tag}] {len(res['losses'])} steps, losses "
          f"{['%.4f' % x for x in res['losses']]}, max rel diff to the "
          f"one-process run {worst:.3e} (<= {Z_RTOL}); model-state "
          f"all-reduces {want_state} per rank; launches per rank "
          f"{want_launches}; {note}", flush=True)
    return ranks


def start_z4_cpu():
    """(z4)'s reference: the same two ranks on the CPU, a child process
    started at the phase's start -> (process, JSON path, log path)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_cpu_")
    out, log = os.path.join(tmp, "out.json"), os.path.join(tmp, "log.txt")
    return start_ranks(Z4_ARGS, 2, out, log, device="cpu"), out, log


def mesh_paths(refs) -> None:
    """Phase 7: (z1)-(z3) against phase 4's one-process runs of the same
    flags (``refs``), (z4) against its one-process run on the card and,
    for its misses, the same two ranks on the CPU (a child started first,
    beside (z1)-(z3))."""
    t7 = time.time() - START
    print(f"[7 mesh] from {t7:.1f} s of the script", flush=True)
    free()
    z4_cpu = start_z4_cpu()
    try:
        mesh_card_paths(refs, z4_cpu)
    finally:
        stop_ranks(z4_cpu[0])
    print(f"[7 mesh] {time.time() - START - t7:.1f} s; the script "
          f"{time.time() - START:.1f} s", flush=True)


def mesh_card_paths(refs, z4_cpu) -> None:
    """(z1)-(z4) on the card, their launches started side by side (the
    script's time: their walls share the host's cores)."""
    from repro_torch.launch import train as launch
    runs = [z_launch(MAIN_ARGS, 1), z_launch(PATH_E_ARGS, 2),
            z_launch(PATH_G[0], 2), z_launch(Z4_ARGS, 2)]
    try:
        z_path("(z1) vrl_sgd+sgd, NCCL world 1", MAIN_ARGS, 1, "nccl",
               {"pod+data": (4, 0)}, MAIN_LAUNCHES, refs["main"],
               launch=runs[0])
        z_path("(z2) vrl_sgd+sgd --overlap, gloo world 2",
               PATH_E_ARGS, 2, "gloo", {"pod+data": (2, 2)},
               PATH_E_LAUNCHES, refs["e"], launch=runs[1])
        z_path("(z3) hier_vrl_sgd (2, 2), gloo world 2", PATH_G[0], 2,
               "gloo", {"data": (2, 0), "pod": (1, 0)}, PATH_G[1],
               refs["g"], grid=(2, 2), launch=runs[2])
        cpu = ranks_result("(z4) on the CPU", *z4_cpu, 2)
        one = launch.run(Z4_ARGS)
        ranks = z_path("(z4) smoke hier (2, 2) int8 / topk:32 --overlap "
                       "--deadline 0.25, gloo world 2", Z4_ARGS, 2, "gloo",
                       {"data": (4, 0), "pod": (2, 2)}, Z4_LAUNCHES,
                       {"losses": one.losses, "avg": one.avg_model_losses,
                        "misses": cpu[0]["misses"]}, grid=(2, 2), lr=LR,
                       launch=runs[3])
    finally:
        for proc, _, _ in runs:
            stop_ranks(proc)
    # the card's first loss beside the CPU's, from the same parameters:
    # the smoke model's forward under the reference's init (attention near
    # one-hot) parts the two GEMM orders before any update, so the card is
    # held to its own one-process run, the CPU only to the misses
    first = ranks[0]["losses"][0] / cpu[0]["losses"][0] - 1
    # the step wall (round_step only) beside the same flags as one process
    # on the card and the two ranks on the CPU
    walls = [1e3 * r["wall_s"] / len(r["losses"]) for r in ranks]
    print(f"[7 mesh (z4)] misses {ranks[0]['misses']} as the CPU ranks "
          f"draw them; step-1 loss card / CPU − 1 = {first:.3e} (not held); "
          f"step wall ms: gloo world 2 on the card "
          f"{', '.join('%.1f' % w for w in walls)} (ranks), one process on "
          f"the card {1e3 * one.wall_s / len(one.losses):.1f}, gloo world 2 "
          f"on the CPU {1e3 * cpu[0]['wall_s'] / len(cpu[0]['losses']):.1f}",
          flush=True)


# ----------------------------------------------------------------- phase 8
def backbone_inputs(cfg, b, s, seed):
    """Seeded inputs (token ids, or frame embeddings (b, s, F) for the
    codec frontend) and next-token labels, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    labels = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    if cfg.frontend == "codec":
        return torch.randn((b, s, cfg.frontend_dim), generator=gen), labels
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    return toks, torch.roll(toks, -1, dims=-1)


def backbone_loss_grads(cfg, params, x, labels, remat, chunk):
    """The LM loss and its per-leaf gradients as ``make_train_step``'s
    loss takes them (``chunk`` > 0: the vocab-streaming loss on the hidden
    states); the leaves the loss does not read are left out."""
    from repro_torch import tree as tm
    from repro_torch.models import transformer as T
    from repro_torch.train import loss as L
    pairs = tm.leaves_with_path(params)
    leaves = [p.clone().requires_grad_() for _, p in pairs]
    p = tm.from_paths([(path, x) for (path, _), x in zip(pairs, leaves)])
    if chunk:
        tied = cfg.tie_embeddings
        loss = L.chunked_cross_entropy_lm(
            T.forward(cfg, p, x, remat=remat, return_hidden=True),
            p["embed"] if tied else p["lm_head"], labels, chunk=chunk,
            head_is_embed=tied)
    else:
        loss = L.cross_entropy_lm(T.forward(cfg, p, x, remat=remat), labels)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [(path, g) for (path, _), g in zip(pairs, grads)
                           if g is not None]


def grads_close(tag, got, want) -> float:
    """Per-leaf gradients within 1e-3 · max|g| of ``want``'s; returns the
    largest error over its limit."""
    worst = 0.0
    if [p for p, _ in got] != [p for p, _ in want]:
        raise AssertionError(f"{tag}: gradient leaves differ")
    for (path, b), (_, a) in zip(got, want):
        err = (b.to(a.device) - a).abs().max().item()
        limit = 1e-3 * a.abs().max().item() + 1e-12
        if not err <= limit:
            raise AssertionError(f"{tag}: gradient {path} max abs err "
                                 f"{err:.3e} (limit {limit:.3e})")
        worst = max(worst, err / limit)
    return worst


def backbone_small_input(dev, vu, card) -> None:
    """Phase 8's smoke checks: the four architectures at the smoke size on
    the card against the CPU from the same parameters: forward logits
    (atol 1e-4); the loss (rtol 1e-5) and every gradient (1e-3 · max|g|)
    with remat off and on, through the full and the vocab-streaming loss
    at a chunk that does not divide the vocabulary; prefill logits and
    cache, then decode logits over drawn inputs (atol 1e-4); and a
    vrl_sgd slice through ``make_train_step`` (W = 2, rounds of 1, 2, 2,
    the engine's kernels on the card; chunked_ce for gemma-7b, frame
    embeddings (W, B, S, F) for musicgen-large, wq, wk × 0.1): losses rtol
    1e-4, params atol 1e-4, Δ atol 1e-4/(k γ)."""
    from repro_torch import tree as tm
    from repro_torch.configs import registry
    from repro_torch.configs.base import VRLConfig
    from repro_torch.models import transformer as T
    from repro_torch.train.train_loop import make_train_step
    w, k = 2, 2
    for arch in BACKBONE:
        cfg = registry.smoke_arch(arch)
        params = T.init_params(cfg, seed=0)
        on_card = tm.tree_map(lambda x: x.to(dev), params)
        x, labels = backbone_inputs(cfg, 2, 16, 1)
        with torch.no_grad():
            close(T.forward(cfg, on_card, x.to(dev)).cpu(),
                  T.forward(cfg, params, x), 1e-4, f"{arch} smoke logits")
        worst_l, worst_g = 0.0, 0.0
        for remat, chunk in BACKBONE_LOSSES:
            lc, gc = backbone_loss_grads(cfg, params, x, labels, remat, chunk)
            lg, gg = backbone_loss_grads(cfg, on_card, x.to(dev),
                                         labels.to(dev), remat, chunk)
            rel = abs(lg.item() / lc.item() - 1)
            if not rel <= 1e-5:
                raise AssertionError(f"{arch} smoke loss (remat {remat}, "
                                     f"chunk {chunk}): rel diff {rel:.3e}")
            worst_l = max(worst_l, rel)
            worst_g = max(worst_g, grads_close(
                f"{arch} smoke (remat {remat}, chunk {chunk})",
                [(p_, g.cpu()) for p_, g in gg], gc))
        xs, _ = backbone_inputs(cfg, 2, 12, 2)
        with torch.no_grad():
            lc, cc = T.prefill(cfg, params, xs[:, :8], 16)
            lg, cg = T.prefill(cfg, on_card, xs[:, :8].to(dev), 16)
            close(lg.cpu(), lc, 1e-4, f"{arch} smoke prefill logits")
            for key in cc:
                close(cg[key].cpu(), cc[key],
                      1e-4 * max(1.0, cc[key].abs().max().item()),
                      f"{arch} smoke prefill cache {key}")
            for pos in range(8, 12):
                lc, cc = T.decode_step(cfg, params, cc, xs[:, pos:pos + 1],
                                       pos)
                lg, cg = T.decode_step(cfg, on_card, cg,
                                       xs[:, pos:pos + 1].to(dev), pos)
                close(lg.cpu(), lc, 1e-4, f"{arch} smoke decode at {pos}")
        # the train slice from the init with wq, wk × 0.1 (soft attention)
        attn = params["layers"]["attn"]
        attn["wq"], attn["wk"] = attn["wq"] * 0.1, attn["wk"] * 0.1
        chunk = BACKBONE_SMOKE_CHUNK if cfg.tie_embeddings else 0
        vrl = VRLConfig(comm_period=k, learning_rate=LR, warmup=True)
        toks, lab = backbone_inputs(cfg, 5 * w * 2, 16, 3)
        toks = toks.reshape(5, w, 2, *toks.shape[1:])
        lab = lab.reshape(5, w, 2, 16)
        runs = {}
        for where in ("cpu", dev):
            bundle = make_train_step(cfg, vrl, device=where,
                                     chunked_ce=chunk)
            state = bundle.engine.init(
                tm.tree_map(lambda x: x.to(where), params), w)
            vu.reset_launches()
            losses, t = [], 0
            for rk in (1, k, k):
                state, lk = bundle.round_step(state, toks[t:t + rk].to(where),
                                              lab[t:t + rk].to(where))
                losses += lk.tolist()
                t += rk
            runs[str(where)] = (np.array(losses), state.params.cpu().numpy(),
                                state.delta.cpu().numpy(),
                                dict(vu.LAUNCHES))
        (l_c, p_c, d_c, _), (l_g, p_g, d_g, n_g) = runs["cpu"], runs[str(dev)]
        check_launches(f"{arch} smoke slice", n_g,
                       {"fused_local_sgd": 5, "fused_sync_vrl": 3})
        np.testing.assert_allclose(l_g, l_c, rtol=1e-4)
        np.testing.assert_allclose(p_g, p_c, rtol=0, atol=1e-4)
        np.testing.assert_allclose(d_g, d_c, rtol=0, atol=1e-4 / (k * LR))
        print(f"[8 backbone] {arch} smoke ({cfg.mlp_act} MLP"
              + (", codec frame embeddings" if cfg.frontend else "")
              + f"), card vs CPU: logits, prefill and cache, 4 decode steps "
              f"within atol 1e-4; loss max rel diff {worst_l:.2e} (rtol "
              f"1e-5) and gradients at most {worst_g:.3f} of 1e-3 · max|g| "
              f"over remat off/on × full / chunked CE (chunk "
              f"{BACKBONE_SMOKE_CHUNK}, vocab {cfg.vocab_size}); vrl_sgd "
              f"slice (W 2, rounds 1, 2, 2"
              + (f", chunked_ce {chunk}" if chunk else "")
              + f"): losses max rel diff {np.abs(l_g / l_c - 1).max():.2e}, "
              f"params {np.abs(p_g - p_c).max():.2e}, Δ "
              f"{np.abs(d_g - d_c).max():.2e}; {card}", flush=True)


def timed_generate(eng, dev, prompt, steps):
    """``eng.generate`` with its timings, the card's peak over it."""
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    timings: dict = {}
    t0 = time.perf_counter()
    out = eng.generate(prompt, steps, timings=timings)
    wall = time.perf_counter() - t0
    return out, timings, wall, torch.cuda.max_memory_allocated(dev)


def chameleon_path(dev, card):
    """(ad) chameleon-34b at full width, depth cut to CHAMELEON_LAYERS,
    through ``serve.Engine``: the serve CLI's traffic and draws (weights
    from seed 0, prompts from seed 1), then ``served_checks``."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    cfg = dataclasses.replace(registry.get_arch("chameleon-34b"),
                              num_layers=CHAMELEON_LAYERS)
    b, s, gen = BACKBONE_SERVE
    eng = Engine(cfg, T.init_params(cfg, 0, device=dev), max_len=s + gen,
                 device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    out, timings, wall, peak = timed_generate(eng, dev, prompt, gen)
    row = served_checks("(ad) serve.Engine",
                        f"chameleon-34b at {CHAMELEON_LAYERS} of 48 layers",
                        cfg, eng, prompt, out, timings["prefill_ms"],
                        timings["decode_ms"], wall, peak, "8 backbone", card)
    del eng, out
    free()
    return row


def codec_path(dev, card):
    """(ac) musicgen-large at full depth through ``transformer.prefill``
    and ``decode_step`` over seeded frame embeddings (the CLIs draw token
    ids and refuse a codec architecture): a prompt of ``s`` frames, then
    ``gen`` decode frames, each timed as ``Engine.generate`` times its
    steps; then ``served_checks`` on an engine of the two functions."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    cfg = registry.get_arch("musicgen-large")
    b, s, gen = BACKBONE_SERVE
    params = T.init_params(cfg, 0, device=dev)
    frames = torch.randn((b, s + gen, cfg.frontend_dim),
                         generator=torch.Generator().manual_seed(1)).to(dev)

    @torch.no_grad()
    def prefill(x):
        return T.prefill(cfg, params, x, s + gen, last_only=True)

    @torch.no_grad()
    def step(cache, x, pos):
        return T.decode_step(cfg, params, cache, x, pos)
    eng = types.SimpleNamespace(params=params, prefill=prefill, step=step)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _, cache = prefill(frames[:, :s])
    torch.cuda.synchronize(dev)
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    decode_ms = []
    for pos in range(s, s + gen):
        t1 = time.perf_counter()
        logits, cache = step(cache, frames[:, pos:pos + 1], pos)
        torch.cuda.synchronize(dev)
        decode_ms.append(1e3 * (time.perf_counter() - t1))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(logits.shape) != (b, 1, cfg.vocab_size):
        raise AssertionError(f"path (ac): logits {tuple(logits.shape)}")
    del cache, logits
    row = served_checks("(ac) prefill/decode_step", "musicgen-large", cfg,
                        eng, frames[:, :s], frames, prefill_ms, decode_ms,
                        wall, peak, "8 backbone", card)
    del eng, params, frames
    free()
    return row


def backbone_train(dev, vu, card):
    """(ae) stablelm-3b and (af) gemma-7b training at full width, depth
    cut, through ``make_train_step`` and ``round_step`` (vrl_sgd + sgd,
    W = 4, k = 2, 4 steps: fused_local_sgd 4, fused_sync_vrl 2 each run):
    (ae) with remat off and on, the losses held to 1e-6 relative; (af)
    with ``chunked_ce`` = GEMMA_CHUNK (256,000 is not a multiple of it, so
    the last chunk is padded at full width) and 0, the first step's loss
    held to 1e-5 relative, then one step's gradients of the two losses
    through ``grads_fn`` (W = 1, worker 0's batch) from one state, per
    leaf within 1e-3 · max|g|."""
    from repro_torch.configs import registry
    from repro_torch.train.train_loop import make_train_step
    from repro_torch.configs.base import VRLConfig
    vrl_kw = dict(comm_period=2, warmup=False, learning_rate=MAIN_LR)
    stab = dataclasses.replace(registry.get_arch("stablelm-3b"),
                               num_layers=STABLELM_TRAIN_LAYERS)
    runs = {}
    for remat in (False, True):
        runs[remat] = train_path(f"(ae) stablelm-3b vrl_sgd+sgd, remat "
                                 f"{'on' if remat else 'off'}", vrl_kw,
                                 TRAIN8_ROUNDS, TRAIN8_LAUNCHES, dev, vu,
                                 cfg=stab, make_kw=dict(remat=remat))
        print_path(runs[remat], f"; {STABLELM_TRAIN_LAYERS} of 32 layers; "
                   f"{card}", phase="8 backbone")
    off, on = (np.array(runs[r]["losses"]) for r in (False, True))
    rel = float(np.abs(on / off - 1).max())
    if not rel <= 1e-6:
        raise AssertionError(f"path (ae): remat on vs off losses {rel:.3e} "
                             f"apart (limit 1e-6)")
    print(f"[8 backbone (ae)] remat on vs off: losses max rel diff "
          f"{rel:.3e} (limit 1e-6; {'bitwise' if rel == 0 else 'not bitwise'}"
          f"), peak {runs[False]['peak_gib']:.2f} -> "
          f"{runs[True]['peak_gib']:.2f} GiB, step wall "
          f"{runs[False]['wall_ms']:.1f} -> {runs[True]['wall_ms']:.1f} ms; "
          f"{card}", flush=True)
    gemma = dataclasses.replace(registry.get_arch("gemma-7b"),
                                num_layers=GEMMA_TRAIN_LAYERS)
    g_runs = {}
    for chunk in (GEMMA_CHUNK, 0):
        g_runs[chunk] = train_path(
            f"(af) gemma-7b vrl_sgd+sgd, chunked_ce {chunk}", vrl_kw,
            TRAIN8_ROUNDS, TRAIN8_LAUNCHES, dev, vu, cfg=gemma, batch=4,
            make_kw=dict(chunked_ce=chunk))
        print_path(g_runs[chunk], f"; {GEMMA_TRAIN_LAYERS} of 28 layers, "
                   f"batch 4 x seq 64; {card}", phase="8 backbone")
    l0 = [g_runs[c]["losses"][0] for c in (GEMMA_CHUNK, 0)]
    rel = abs(l0[0] / l0[1] - 1)
    if not rel <= 1e-5:
        raise AssertionError(f"path (af): first losses {l0} (rel "
                             f"{rel:.3e}, limit 1e-5)")
    # one step's gradients of the two losses from one state, worker 0
    from repro_torch.data import assigned_token_stream, contiguous_assignment
    vrl = VRLConfig(**vrl_kw)
    bundles = {c: make_train_step(gemma, vrl, device=dev, chunked_ce=c)
               for c in (GEMMA_CHUNK, 0)}
    state = bundles[GEMMA_CHUNK].init_state(0, 1)
    data = assigned_token_stream(contiguous_assignment(4, 4), 64,
                                 gemma.vocab_size, steps=1, batch=4,
                                 alpha=0.05, seed=0)
    toks = torch.from_numpy(data[0, :1]).to(dev, torch.long)
    labels = torch.roll(toks, -1, dims=-1)
    g_chunk, _ = bundles[GEMMA_CHUNK].grads_fn(state, toks, labels)
    g_full, _ = bundles[0].grads_fn(state, toks, labels)
    spec = bundles[0].engine.spec
    worst = 0.0
    for leaf in spec.leaves:
        a = g_full.reshape(-1)[leaf.offset:leaf.offset + leaf.size]
        b = g_chunk.reshape(-1)[leaf.offset:leaf.offset + leaf.size]
        err = (b - a).abs().max().item()
        limit = 1e-3 * a.abs().max().item() + 1e-12
        if not err <= limit:
            raise AssertionError(f"path (af): gradient {leaf.path} max abs "
                                 f"err {err:.3e} (limit {limit:.3e})")
        worst = max(worst, err / limit)
    del bundles, state, g_chunk, g_full
    free()
    c, f = g_runs[GEMMA_CHUNK], g_runs[0]
    print(f"[8 backbone (af)] chunked_ce {GEMMA_CHUNK} vs full: first loss "
          f"{l0[0]:.6f} vs {l0[1]:.6f} (rel {rel:.3e}, limit 1e-5); one "
          f"step's gradients of worker 0 from one state at most "
          f"{worst:.3f} of 1e-3 · max|g| over {len(spec.leaves)} leaves; "
          f"peak {c['peak_gib']:.2f} vs {f['peak_gib']:.2f} GiB, step wall "
          f"{c['wall_ms']:.1f} vs {f['wall_ms']:.1f} ms; {card}", flush=True)
    return [*runs.values(), *g_runs.values()]


def backbone_phase(dev, vu, fa, ss, card) -> list:
    """Phase 8: the smoke checks, then (aa)-(ad) served and (ae), (af)
    trained at full width; returns the training paths' results."""
    t8 = time.time() - START
    print(f"[8 backbone] from {t8:.1f} s of the script; {card}", flush=True)
    free()
    backbone_small_input(dev, vu, card)
    serve_args = ["--batch", str(BACKBONE_SERVE[0]), "--prompt-len",
                  str(BACKBONE_SERVE[1]), "--gen", str(BACKBONE_SERVE[2])]
    serve_path("(aa) serve", "stablelm-3b", vu, fa, ss, serve_args,
               "8 backbone", card)
    serve_path("(ab) serve", "gemma-7b", vu, fa, ss, serve_args,
               "8 backbone", card)
    for path in (codec_path, chameleon_path):
        for mod in (vu, fa, ss):
            mod.reset_launches()
        row = path(dev, card)
        check_launches(row["tag"], {**vu.LAUNCHES, **fa.LAUNCHES,
                                    **ss.LAUNCHES}, {})
    res = backbone_train(dev, vu, card)
    print(f"[8 backbone] {time.time() - START - t8:.1f} s; the script "
          f"{time.time() - START:.1f} s", flush=True)
    return res

# ----------------------------------------------------------------- phase 9
CKPT_DIR = os.path.join(ROOT, ".chip_smoke_ckpt")   # git-ignored
# (ag), (ah) at 4 of qwen2-0.5b's 24 layers, full width (phase 12 added;
# at 24 layers the phase took 169.5 s of the script)
CKPT_LAYERS = 4
CKPT_ARGS = ["--arch", "qwen2-0.5b", "--layers", str(CKPT_LAYERS),
             "--workers", "2", "--batch", "8", "--seq", "64", "--steps", "8",
             "--k", "2", "--lr", str(MAIN_LR), "--log-every", "1", "--diag",
             "--ckpt-every", "4"]
CKPT_LAUNCHES = {"fused_local_sgd": 8, "fused_sync_vrl": 4}
CKPT_RESUMED_LAUNCHES = {"fused_local_sgd": 4, "fused_sync_vrl": 2}
CKPT_SMOKE = ["--arch", "qwen2-0.5b", "--smoke", "--workers", "2", "--batch",
              "2", "--seq", "32", "--steps", "6", "--k", "2", "--lr", str(LR),
              "--ckpt-every", "2"]
# (ai): VRLConfig fields over a small template, W = 4
CKPT_STATES = {
    "adam+sm3, bf16 moments, 2 shards": dict(
        algorithm="vrl_sgd", inner_optimizer="adam", sm3=True,
        moment_dtype="bfloat16", shards=2),
    "hier (2, 2)+int8+overlap": dict(algorithm="hier_vrl_sgd",
                                     compress="int8", overlap=True)}


class _Tee:
    """stdout, copied into a buffer (to read what a CLI printed)."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


@contextlib.contextmanager
def counting_means():
    """Count ``comm.collectives.worker_mean`` calls by kind ("state": the
    model-state means of a round, on one process a reduction over the
    worker dim)."""
    from repro_torch.comm import collectives as coll
    orig, counts = coll.worker_mean, {}

    def counted(mesh, buf, dim, axes, *, kind="state", **kw):
        counts[kind] = counts.get(kind, 0) + 1
        return orig(mesh, buf, dim, axes, kind=kind, **kw)
    coll.worker_mean = counted
    try:
        yield counts
    finally:
        coll.worker_mean = orig


def npz_path(d):
    return os.path.join(d, "arrays.npz")


def same_checkpoint(tag, a, b) -> int:
    """Every array of checkpoints ``a`` and ``b`` bitwise equal, read one
    key at a time; returns the bytes compared."""
    from repro_torch.checkpoint import ArrayFile
    with ArrayFile(npz_path(a)) as fa, ArrayFile(npz_path(b)) as fb:
        keys = sorted(k for k in fa.files if k != "__meta__")
        if keys != sorted(k for k in fb.files if k != "__meta__"):
            raise AssertionError(f"{tag}: keys {keys} vs {fb.files}")
        n = 0
        for k in keys:
            x, y = fa[k], fb[k]
            if (x.dtype, x.shape) != (y.dtype, y.shape) or \
                    not np.array_equal(x.reshape(-1).view(np.uint8),
                                       y.reshape(-1).view(np.uint8)):
                raise AssertionError(f"{tag}: {k} differs")
            n += x.nbytes
    return n


def ckpt_bound(res, w=2, k=2, lr=MAIN_LR) -> tuple:
    """Phase 4's Σ Δ bound over a CLI run's log (``cli_path`` with
    ``rounding``): 1e-4 · the largest |Δ| it logged plus the fp32 rounding
    of x̂ its syncs keep, 2 W ulp(max|p|)/(k γ) each."""
    max_d = max(m for _, _, m in res.invariant)
    ulp = float(np.spacing(np.float32(max(m for _, m in res.param_max))))
    syncs = len(res.losses) // k
    return 1e-4 * max_d + syncs * 2 * w * ulp / (k * lr), max_d


def ckpt_full_width(dev, vu, card, launch) -> str:
    """(ag): the uninterrupted run, the resumed run, the timed save,
    restore and diagnostics pass; returns the step-4 checkpoint."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.comm import compressors as comm_mod
    from repro_torch.obs import diagnostics as obs_diag
    from repro_torch.obs.metrics import read_metrics
    d1, d2 = (os.path.join(CKPT_DIR, n) for n in ("run", "resumed"))
    m1, m2 = (os.path.join(CKPT_DIR, n) for n in ("run.jsonl",
                                                   "resumed.jsonl"))
    vu.reset_launches()
    full = launch.run(CKPT_ARGS + ["--ckpt", d1, "--metrics", m1])
    check_launches("(ag) uninterrupted", dict(vu.LAUNCHES), CKPT_LAUNCHES)
    n_run = {k: v for k, v in vu.LAUNCHES.items() if v}
    vu.reset_launches()
    res = launch.run(CKPT_ARGS + ["--ckpt", d2, "--metrics", m2,
                                  "--resume", ckpt.step_dir(d1, 4)])
    check_launches("(ag) resumed", dict(vu.LAUNCHES), CKPT_RESUMED_LAUNCHES)
    if res.start_step != 4 or res.losses != full.losses[4:]:
        raise AssertionError(f"(ag): resumed losses {res.losses} vs "
                             f"{full.losses[4:]}")
    nbytes = same_checkpoint("(ag) step 8", ckpt.step_dir(d1, 8),
                             ckpt.step_dir(d2, 8))
    limit, max_d = ckpt_bound(full)
    recs = read_metrics(m1) + read_metrics(m2)
    diags = [r for r in recs if r["event"] == "diag"]
    worst = max(r["delta_residual"] for r in diags)
    if worst * 2 > limit or any(r["alarms"] or r["nonfinite_workers"]
                                for r in diags):
        raise AssertionError(f"(ag): diag records {diags} against the "
                             f"bound {limit} / W")
    events = [r["event"] for r in read_metrics(m2)]
    if events != (["run_start", "restore"] + ["round", "sync", "diag",
                                              "eval"] * 2
                  + ["checkpoint", "run_end"]):
        raise AssertionError(f"(ag): resumed stream events {events}")
    phases = read_metrics(m1)[-1]["phases"]
    cli_save = phases["checkpoint"]["total_s"] / phases["checkpoint"]["n"]
    print(f"[9 ckpt (ag)] qwen2-0.5b at {CKPT_LAYERS} of 24 layers, W = 2: "
          f"the resumed steps 5-8 bitwise "
          f"({['%.6f' % x for x in res.losses]}), the step-8 checkpoint "
          f"bitwise ({nbytes / 1e9:.2f} GB compared); launches {n_run} "
          f"uninterrupted, {CKPT_RESUMED_LAUNCHES} resumed; "
          f"{len(diags)} diag records, max delta_residual · W "
          f"{2 * worst:.3e} <= {limit:.3e} (1e-4 · max|Δ| {1e-4 * max_d:.3e} "
          f"+ x̂ rounding); CLI save "
          f"{cli_save:.2f} s a checkpoint; {card}", flush=True)
    # the timed save, restore and diagnostics pass, on the final state
    eng, state = full.engine, full.state
    comps = comm_mod.pair_meta(eng.compressors)
    vrl_moments = ckpt.moments_meta(launch.vrl_config(
        launch.parse_args(CKPT_ARGS)))
    d3 = os.path.join(CKPT_DIR, "timed")
    free()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ckpt.save_flat_state(d3, state, eng.spec, meta={"step": 8},
                         compressors=comps, moments=vrl_moments)
    save_s = time.perf_counter() - t0
    grow = torch.cuda.max_memory_allocated() - base
    leaf = max(x.numel() * x.element_size() for x in (state.params,
                                                      state.delta))
    if grow > leaf:
        raise AssertionError(f"(ag): the save grew the device memory by "
                             f"{grow} B, more than one leaf ({leaf} B)")
    size = os.path.getsize(npz_path(d3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = ckpt.restore_flat_state(d3, state, eng.spec, compressors=comps,
                                   moments=vrl_moments)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if not (torch.equal(back.params, state.params)
            and torch.equal(back.delta, state.delta)
            and back.params.device == state.params.device):
        raise AssertionError("(ag): the timed restore is not the state")
    del back
    shutil.rmtree(d3)
    free()
    eng.diagnostics(state)                  # warm
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = obs_diag.to_record(eng.diagnostics(state))
        ms.append(1e3 * (time.perf_counter() - t0))
    print(f"[9 ckpt (ag)] save {size / 1e9:.3f} GB in {save_s:.2f} s "
          f"({size / 1e9 / save_s:.2f} GB/s; device memory grew "
          f"{grow} B, one leaf is {leaf} B), restore {restore_s:.2f} s "
          f"({size / 1e9 / restore_s:.2f} GB/s) onto {dev}; one "
          f"diagnostics pass {sorted(ms)[1]:.1f} ms (median of "
          f"{['%.1f' % x for x in ms]}): {obs_diag.describe(rec)}; {card}",
          flush=True)
    del full, res, state
    free()
    return ckpt.step_dir(d1, 4)


def ckpt_reshard(dev, vu, card, launch, path):
    """(ah): W = 2's step-4 file onto W = 4 through ``restore_resharded``
    (what ``launch.train --resume`` calls when ``--workers`` changed), then
    two rounds through ``make_train_step``.  (The CLI itself, as the
    reference's, refuses to grow past the saved data assignment's shards:
    ``ckpt_mesh`` shows that at the smoke width.)"""
    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import registry
    from repro_torch.core import engine as engine_mod
    from repro_torch.data import assigned_token_stream, contiguous_assignment
    from repro_torch.train.train_loop import make_train_step
    argv = list(CKPT_ARGS)
    argv[argv.index("--workers") + 1] = "4"
    args = launch.parse_args(argv)
    vrl = launch.vrl_config(args)
    cfg = dataclasses.replace(
        (registry.smoke_arch if args.smoke else registry.get_arch)(
            args.arch), num_layers=args.layers)
    bundle = make_train_step(cfg, vrl, remat=not args.smoke, device=dev,
                             timed=dev.type == "cuda")
    eng = bundle.engine
    state = bundle.init_state(0, 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = ckpt.restore_resharded(path, state, eng.spec, compressors=None,
                                   moments=ckpt.moments_meta(vrl))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    sum_d, max_d = engine_mod.sum_invariant(state.delta)
    if not sum_d <= 1e-4 * max_d:
        raise AssertionError(f"(ah): Σ_i Δ_i {sum_d} after the resharded "
                             f"restore, max|Δ| {max_d}")
    with ckpt.ArrayFile(npz_path(path)) as f:
        saved = f["params"]
    for j in range(4):
        if not torch.equal(state.params[j].cpu(),
                           torch.from_numpy(saved[j % 2])):
            raise AssertionError(f"(ah): params row {j} is not saved row "
                                 f"{j % 2}")
    del saved
    data = assigned_token_stream(contiguous_assignment(4, 4), args.seq,
                                 cfg.vocab_size, steps=args.steps,
                                 batch=args.batch, alpha=args.alpha,
                                 seed=args.seed)
    vu.reset_launches()
    losses, max_p = [], amax(state.params)
    with counting_means() as means:
        for t in (4, 6):
            toks = torch.from_numpy(data[t:t + 2]).to(dev, torch.long)
            state, loss = bundle.round_step(state, toks,
                                            torch.roll(toks, -1, dims=-1))
            losses += loss.tolist()
            max_p = max(max_p, amax(state.params))
    check_launches("(ah)", dict(vu.LAUNCHES), CKPT_RESUMED_LAUNCHES)
    if means.get("state") != 2 or not all(map(math.isfinite, losses)):
        raise AssertionError(f"(ah): worker means {means}, losses {losses}")
    # after the two syncs Σ Δ holds phase 4's bound with the x̂ rounding
    # (here Δ is the rounding residue of params near 1e8: the restored Δ,
    # ~5e10, folded in and cancelled)
    sum_d2, max_d2 = engine_mod.sum_invariant(state.delta)
    limit2 = 1e-4 * max_d2 + 2 * 2 * 4 * float(np.spacing(np.float32(
        max_p))) / (2 * args.lr)
    if not sum_d2 <= limit2:
        raise AssertionError(f"(ah): Σ_i Δ_i {sum_d2} after two rounds, "
                             f"limit {limit2}")
    del state, bundle, eng
    free()
    print(f"[9 ckpt (ah)] resharded 2 -> 4 workers in {restore_s:.2f} s: "
          f"right after the restore max|Σ_i Δ_i| {sum_d:.3e} <= 1e-4 · "
          f"max|Δ| {1e-4 * max_d:.3e}, params rows the tiled saved rows "
          f"(bitwise); two rounds: losses {['%.4f' % x for x in losses]}, "
          f"one model-state worker mean a round ({means}), launches "
          f"{CKPT_RESUMED_LAUNCHES}, after them max|Σ_i Δ_i| {sum_d2:.3e} "
          f"<= {limit2:.3e} (1e-4 · max|Δ| {max_d2:.3e} + x̂ rounding at "
          f"max|p| {max_p:.3e}); {card}", flush=True)


def ckpt_states(dev, vu, card):
    """(ai) states: saved and restored bitwise, then continued bitwise."""
    from repro_torch import checkpoint as ckpt
    from repro_torch import tree as tm
    from repro_torch.comm import compressors as comm_mod
    from repro_torch.configs.base import EngineConfig, HierConfig, VRLConfig
    from repro_torch.core import engine as engine_mod
    tpl = {"w": (48, 40), "b": (70,), "u": (3, 5, 33)}
    rng = np.random.RandomState(9)
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in tpl.items()}
    for tag, kw in CKPT_STATES.items():
        kw = dict(kw)
        comp, shards = kw.pop("compress", None), kw.pop("shards", 1)
        vrl = VRLConfig(comm_period=2, learning_rate=LR, warmup=False,
                        compress=(comm_mod.parse_compressor(comp) if comp
                                  else None),
                        hier=(HierConfig(k1=2, k2=4, grid=(2, 2))
                              if kw["algorithm"] == "hier_vrl_sgd"
                              else None),
                        engine=EngineConfig(block=8, shards=shards), **kw)
        eng = engine_mod.make_engine(vrl, {k: torch.empty(s, device="meta")
                                           for k, s in tpl.items()},
                                     device=dev)
        lead = tuple(eng.grid) if eng.grid is not None else (4,)

        def fresh():
            return eng.init({k: torch.from_numpy(v).to(dev)
                             for k, v in p0.items()}, 4)

        def rounds(state, seeds):
            for seed in seeds:
                g = np.zeros((2, 4, eng.spec.rows * eng.spec.lanes),
                             np.float32)
                g[..., :eng.spec.size] = np.random.RandomState(
                    seed).randn(2, 4, eng.spec.size)
                state = eng.round_step_flat(state, torch.from_numpy(
                    g.reshape(2, *lead, eng.spec.rows, eng.spec.lanes)
                ).to(dev))
            return state

        def host(state):
            return {k: (v.cpu().clone() if isinstance(v, torch.Tensor)
                        else v) for k, v in tm.state_leaves(state)}

        vu.reset_launches()
        state = rounds(fresh(), (1, 2))
        d = os.path.join(CKPT_DIR, "states")
        meta = dict(grid=eng.grid,
                    compressors=comm_mod.pair_meta(eng.compressors),
                    moments=ckpt.moments_meta(vrl))
        ckpt.save_flat_state(d, state, eng.spec, **meta)
        saved = host(state)
        unbroken = host(rounds(state, (3, 4)))
        restored = ckpt.restore_flat_state(d, fresh(), eng.spec, **meta)
        again = host(restored)
        cont = host(rounds(restored, (3, 4)))
        for name, got, want in (("restored", again, saved),
                                ("continued", cont, unbroken)):
            for k, v in want.items():
                g = got[k]
                same = (g == v if not isinstance(v, torch.Tensor) else
                        g.dtype == v.dtype and torch.equal(
                            g.view(torch.int16) if g.dtype ==
                            torch.bfloat16 else g,
                            v.view(torch.int16) if v.dtype ==
                            torch.bfloat16 else v))
                if not same:
                    raise AssertionError(f"(ai) {tag}: {name} {k} differs")
        dtypes = sorted({str(v.dtype).replace("torch.", "")
                         for v in saved.values()
                         if isinstance(v, torch.Tensor)})
        print(f"[9 ckpt (ai)] {tag}: {len(saved)} leaves ({dtypes}) saved "
              f"and restored bitwise, two more rounds from the restored "
              f"state bitwise the unbroken run's; launches "
              f"{ {k: v for k, v in vu.LAUNCHES.items() if v} }; {card}",
              flush=True)
        shutil.rmtree(d)


def ckpt_mesh(vu, card, launch):
    """(ai) mesh: gloo world 2 saves, one process on the card resumes."""
    from repro_torch import checkpoint as ckpt
    dm, d1, d2 = (os.path.join(CKPT_DIR, n) for n in ("mesh", "one",
                                                      "resumed_one"))
    out, log = (os.path.join(CKPT_DIR, n) for n in ("mesh.json",
                                                    "mesh.txt"))
    ranks = ranks_result("(ai) mesh", start_ranks(
        CKPT_SMOKE + ["--ckpt", dm], 2, out, log), out, log, 2)
    if "gloo" not in ranks[0]["backend"]:
        raise AssertionError(f"(ai) mesh: backend {ranks[0]['backend']}")
    one = launch.run(CKPT_SMOKE + ["--ckpt", d1])
    same_checkpoint("(ai) mesh vs one process", ckpt.step_dir(dm, 6),
                    ckpt.step_dir(d1, 6))
    res = launch.run(CKPT_SMOKE + ["--ckpt", d2, "--resume",
                                   ckpt.step_dir(dm, 2)])
    if res.losses != one.losses[2:] or ranks[0]["losses"] != one.losses:
        raise AssertionError(f"(ai) mesh: losses {ranks[0]['losses']}, "
                             f"resumed {res.losses}, one process "
                             f"{one.losses}")
    same_checkpoint("(ai) resumed at world 1", ckpt.step_dir(d2, 6),
                    ckpt.step_dir(d1, 6))
    # the CLI's resharded resume printing its line, then refusing (as the
    # reference's) to re-split two saved shards over four workers
    argv = list(CKPT_SMOKE)
    argv[argv.index("--workers") + 1] = "4"
    tee, refused = _Tee(sys.stdout), None
    with contextlib.redirect_stdout(tee):
        try:
            launch.run(argv + ["--resume", ckpt.step_dir(dm, 2)])
        except SystemExit as e:
            refused = str(e)
    if "resume: resharding 2 -> 4 workers" not in "".join(tee.text) or \
            not (refused and "cannot give every worker an index" in refused):
        raise AssertionError(f"(ai): the W = 4 resume exited {refused!r}")
    gathers = ranks[0]["collectives"].get("checkpoint")
    print(f"[9 ckpt (ai)] gloo world 2 saved every 2 steps (rank 0 wrote "
          f"the one file, gathers {gathers}; model-state all-reduces "
          f"{ranks[0]['collectives']['state']}); its step-6 file bitwise "
          f"the one process's; one process on the card resumed its step-2 "
          f"file: steps 3-6 and the step-6 file bitwise; at --workers 4 the "
          f"CLI printed its resharding line and refused: {refused}; {card}",
          flush=True)


def ckpt_phase(dev, vu, card) -> None:
    """Phase 9: (ag), (ah), (ai); the directories removed at the end."""
    from repro_torch.launch import train as launch
    t9 = time.time() - START
    free()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    usage = shutil.disk_usage(CKPT_DIR)
    _, rows, lanes = QWEN_CUT_LAYOUTS[CKPT_LAYERS]
    need = 3 * 2 * 2 * rows * lanes * 4             # three W = 2 saves
    print(f"[9 ckpt] from {t9:.1f} s of the script; {CKPT_DIR}: "
          f"{usage.free / 1e9:.1f} GB free of {usage.total / 1e9:.1f} GB, "
          f"(ag) writes {need / 1e9:.1f} GB; {card}", flush=True)
    if usage.free < 1.2 * need:
        raise AssertionError(f"phase 9 needs {need / 1e9:.1f} GB on "
                             f"{CKPT_DIR}; {usage.free / 1e9:.1f} GB free")
    try:
        step4 = ckpt_full_width(dev, vu, card, launch)
        ckpt_reshard(dev, vu, card, launch, step4)
        ckpt_states(dev, vu, card)
        ckpt_mesh(vu, card, launch)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    print(f"[9 ckpt] {time.time() - START - t9:.1f} s; the script "
          f"{time.time() - START:.1f} s", flush=True)


# phase 10, elastic runs and partial participation (``repro_torch.fault``,
# ``Engine.set_membership``, ``core.clients`` through ``launch.train``)
ELASTIC_DIR = os.path.join(ROOT, ".chip_smoke_elastic")   # git-ignored
ELASTIC_FULL = ["--arch", "qwen2-0.5b", "--batch", "8", "--seq", "64",
                "--k", "2", "--lr", str(MAIN_LR), "--log-every", "1"]
# (aj): the NaN round [2, 4) rolled back and replayed, worker 1 out for
# steps 4-7; its twin without the poison (and without the guard) must be
# the same run, bit for bit.  At γ 1e-7: under the init's first gradients
# (~1e12) γ 1e-3 blows the loss up by itself (round means 1.38e7, then
# 5.61e10), which the guard's loss trend rightly calls a divergence; at
# 1e-7 the round means stay near 6e4
AJ_LR = 1e-7
# at phase 4's cut depth, full width (the script's time)
AJ_FULL = cut(ELASTIC_FULL[:ELASTIC_FULL.index("--lr")] + [
    "--lr", str(AJ_LR), "--log-every", "1", "--workers", "4", "--steps",
    "12"])
AJ_ARGS = AJ_FULL + ["--membership", "--guard", "--faults",
                     "nan@2:3,crash@1:4,rejoin@1:8"]
AJ_TWIN = AJ_FULL + ["--membership", "--faults", "crash@1:4,rejoin@1:8"]
AJ_LAUNCHES = {"fused_local_sgd": 14, "fused_sync_vrl": 7}
AJ_TWIN_LAUNCHES = {"fused_local_sgd": 12, "fused_sync_vrl": 6}
# (ak): M = 4 clients over W = 2 slots; the M = W run and its storeless twin
AK_ARGS = ELASTIC_FULL + ["--workers", "2", "--steps", "6", "--clients", "4",
                          "--participation", "0.5"]
AK_MW = ELASTIC_FULL + ["--workers", "2", "--steps", "4", "--clients", "2"]
AK_PLAIN = ELASTIC_FULL + ["--workers", "2", "--steps", "4"]
# (al): the smoke width (mamba2-370m's, 2 layers, d 128: its map is smooth,
# so the card's and the CPU's fp32 roundings stay apart by ulps; qwen2's
# smoke model is chaotic under a pod drop), each run also on the CPU (a
# child process)
AL_LR = 0.02
AL_HIER = ["--arch", MAMBA, "--smoke", "--workers", "4", "--batch",
           "2", "--seq", "40", "--steps", "12", "--lr", str(AL_LR),
           "--algorithm", "hier_vrl_sgd", "--pods", "2", "--k1", "2",
           "--k2", "4", "--compress", "int8", "--membership", "--guard",
           "--faults", "crash@2:2,crash@3:2,crash@0:6,rejoin@0:10,"
           "rejoin@2:10,rejoin@3:10", "--log-every", "1"]
AL_CLIENTS = ["--arch", MAMBA, "--smoke", "--workers", "4",
              "--clients", "8", "--batch", "2", "--seq", "40", "--steps",
              "8", "--k", "2", "--lr", str(AL_LR), "--alpha", "0.1",
              "--faults", "crash@2:3,rejoin@2:5,killsave:6", "--ckpt-every",
              "2", "--log-every", "1"]
# the quickstart's tiny qwen2 under its init is chaotic at the example's
# γ 0.2: one ulp of the init parts two CPU runs past 1e-4 within 20 steps,
# as the card's and the CPU's roundings do
# (tests/test_torch_elastic_cli.py::
# test_quickstart_sensitivity_to_an_ulp_of_its_init); at γ 5e-5 the
# nudged runs stay within 1e-6, and every loss is held
AL_QUICKSTART = ["--steps", "20", "--lr", "5e-05"]


AL_RUNS = {"hier overlap": AL_HIER + ["--overlap"], "hier": AL_HIER,
           "clients": AL_CLIENTS}


def al_starts(root: str) -> None:
    """(al)'s start checkpoints, one per run, at step 0 under ``root``:
    each run's initial state (its clients' store for the client run) drawn
    on the CPU.  The card's and the CPU's runs resume from them, so they
    start from the same weights (torch's generators differ by device)."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.comm import compressors as comm_mod
    from repro_torch.configs import registry
    from repro_torch.core.clients import ClientStore
    from repro_torch.data import partition as partition_mod
    from repro_torch.launch import train as launch
    from repro_torch.train.train_loop import make_train_step
    for tag, argv in AL_RUNS.items():
        args = launch.parse_args(argv + ["--device", "cpu"])
        vrl = launch.vrl_config(args, membership=True)
        bundle = make_train_step(registry.smoke_arch(args.arch), vrl,
                                 remat=False, device="cpu")
        eng, state = bundle.engine, bundle.init_state(args.seed,
                                                      args.workers)
        units = args.clients or args.workers
        meta = {"step": 0, "arch": args.arch, "workers": args.workers,
                "assignment": partition_mod.assignment_to_meta(
                    partition_mod.contiguous_assignment(units, units))}
        kw = dict(compressors=comm_mod.pair_meta(eng.compressors),
                  moments=ckpt.moments_meta(vrl))
        path = os.path.join(root, "start-" + tag.replace(" ", "-"))
        if args.clients:
            meta.update(clients=args.clients, flat_spec=eng.spec.meta(), **kw)
            ckpt.save(path, ClientStore(state, args.clients).to_tree(),
                      meta=meta)
        else:
            ckpt.save_flat_state(path, state, eng.spec, meta=meta,
                                 grid=eng.grid, **kw)


def al_runs(device: str, root: str) -> dict:
    """(al)'s runs on ``device``, each resumed from its step-0 start under
    ``root`` (``al_starts``): the hierarchy with a pod and a worker drop
    under int8, overlapped and blocking; the client run with its store
    checkpoints under ``root``; the quickstart.  Their losses."""
    from repro_torch.examples import quickstart
    from repro_torch.launch import train as launch
    out = {}
    dev = ["--device", device]

    def start(tag):
        return ["--resume", os.path.join(root, "start-" + tag.replace(" ",
                                                                      "-"))]
    for tag in ("hier overlap", "hier"):
        res = launch.run(AL_RUNS[tag] + dev + start(tag))
        out[tag] = {"losses": res.losses, "avg": res.avg_model_losses,
                    "masks": res.elastic["masks"]}
    res = launch.run(AL_CLIENTS + dev + start("clients") + [
        "--ckpt", os.path.join(root, device, "clients")])
    out["clients"] = {"losses": res.losses, "avg": res.avg_model_losses,
                      "masks": res.elastic["masks"]}
    with contextlib.redirect_stdout(io.StringIO()):
        out["quickstart"] = quickstart.main(AL_QUICKSTART + dev)
    return out


def elastic_cpu_runs(path: str, root: str) -> int:
    """The child process of phase 10: (al)'s runs on the CPU from the
    starts under ``root``, their losses as JSON to ``path``.  Started at
    the phase's start, so it runs beside the card's (aj) and (ak)."""
    torch.set_num_threads(3)
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        out = al_runs("cpu", root)
    out["seconds"] = time.time() - START
    with open(path, "w") as f:
        json.dump(out, f)
    return 0


def start_elastic_cpu():
    """Write (al)'s starts, then start ``elastic_cpu_runs`` in a child
    process: (process, its JSON path, its log path)."""
    al_starts(ELASTIC_DIR)
    path, log = (os.path.join(ELASTIC_DIR, n) for n in ("cpu.json",
                                                         "cpu.log"))
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--elastic-cpu",
             path, ELASTIC_DIR], stdout=subprocess.DEVNULL, stderr=err,
            cwd=ROOT)
    return proc, path, log


def delta_bound(res, w, k=2, lr=MAIN_LR) -> float:
    """Phase 4's Σ Δ bound over a CLI run's (masked) log: 1e-4 · the
    largest |Δ| it logged plus the fp32 rounding of x̂ each sync keeps,
    2 W ulp(max|p|)/(k γ)."""
    max_d = max(m for _, _, m in res.invariant)
    ulp = float(np.spacing(np.float32(max(m for _, m in res.param_max))))
    syncs = len(res.losses) // k
    return 1e-4 * max_d + syncs * 2 * w * ulp / (k * lr)


def active_sum(state) -> tuple:
    """(max|Σ_active Δ|, max|Δ| over the active rows) of a flat state."""
    keep = state.member.active > 0
    d = torch.where(keep, state.delta, 0)
    return (torch.linalg.vector_norm(d.sum(0), float("inf")).item(),
            torch.linalg.vector_norm(d, float("inf")).item())


def peak_sites(snap: dict, base: int) -> tuple:
    """The peak of a recorded allocation history (``base``: the bytes held
    when the recording began) and the bytes of its live blocks by
    allocation site, the innermost frame in this repository."""
    live, total, best, at = {}, base, base, {}
    for ev in snap["device_traces"][torch.cuda.current_device()]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            total += ev["size"]
            if total > best:
                best, at = total, dict(live)
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            total -= live.pop(ev["addr"])["size"]
    sites = {"held before the run": base}
    for ev in at.values():
        f = next((f for f in ev["frames"]
                  if f["filename"].startswith(ROOT)), None)
        key = ("?" if f is None else f"{os.path.relpath(f['filename'], ROOT)}"
               f":{f['line']} {f['name']}")
        sites[key] = sites.get(key, 0) + ev["size"]
    return best, sorted(sites.items(), key=lambda kv: -kv[1])


def elastic_full_width(dev, vu, card, launch):
    """(aj): the faulted run, its clean twin, the dead rows' NaN, and the
    full mask bitwise membership off.  ``--trace-memory`` records the
    faulted run's allocations and prints its peak's live blocks by
    site."""
    from repro_torch.obs.metrics import read_metrics
    from repro_torch.train.train_loop import make_train_step
    m = os.path.join(ELASTIC_DIR, "aj.jsonl")
    free()
    torch.cuda.reset_peak_memory_stats()
    vu.reset_launches()
    trace = "--trace-memory" in sys.argv[1:]
    if trace:
        base = torch.cuda.memory_allocated()
        torch.cuda.memory._record_memory_history(max_entries=1_000_000)
    a = launch.run(AJ_ARGS + ["--metrics", m])
    peak = torch.cuda.max_memory_allocated()
    if trace:
        traced, sites = peak_sites(torch.cuda.memory._snapshot(), base)
        torch.cuda.memory._record_memory_history(enabled=None)
        print(f"[10 elastic (aj)] allocation trace: peak "
              f"{traced / 2**30:.2f} GiB, its live blocks by site (GiB): "
              + "; ".join(f"{k} {v / 2**30:.2f}" for k, v in sites
                          if v >= 2**26), flush=True)
    check_launches("(aj)", dict(vu.LAUNCHES), AJ_LAUNCHES)
    recs = read_metrics(m)
    got = {
        "rollback": [(r["t_fail"], r["reason"], r["back_to"]) for r in recs
                     if r["event"] == "rollback"],
        "membership": [(r["t"], r["active"]) for r in recs
                       if r["event"] == "membership"],
        "fault": [(r["t"], r["events"]) for r in recs
                  if r["event"] == "fault"]}
    want = {"rollback": [(4, "non-finite state", 2)],
            "membership": [(4, [1, 0, 1, 1]), (8, [1, 1, 1, 1])],
            "fault": [(2, [{"kind": "nan", "step": 3, "worker": 2}])]}
    if got != want:
        raise AssertionError(f"(aj): events {got}, expected {want}")
    bound = delta_bound(a, 4, lr=AJ_LR)
    worst = max(s for _, s, _ in a.invariant)
    if not worst <= bound:
        raise AssertionError(f"(aj): max|Σ_active Δ| {worst} after a sync "
                             f"> {bound}")
    if not all(math.isfinite(x) for x in a.losses + a.avg_model_losses):
        raise AssertionError(f"(aj): non-finite loss {a.losses}")
    ela = a.elastic
    vu.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    b = launch.run(AJ_TWIN)
    twin_peak = torch.cuda.max_memory_allocated()
    check_launches("(aj) twin", dict(vu.LAUNCHES), AJ_TWIN_LAUNCHES)
    if a.losses != b.losses or not (
            torch.equal(a.state.params, b.state.params)
            and torch.equal(a.state.delta, b.state.delta)):
        raise AssertionError(f"(aj): the rolled-back run {a.losses} is not "
                             f"its clean twin {b.losses}")
    step_ms = 1e3 * b.wall_s / 12
    del b
    free()
    print(f"[10 elastic (aj)] qwen2-0.5b at {CUT_LAYERS} of 24 layers, "
          f"W = 4, --membership --guard "
          f"--faults nan@2:3,crash@1:4,rejoin@1:8: round [2, 4) poisoned, "
          f"rolled back to its start and replayed (losses and final params, "
          f"Δ bitwise the un-poisoned twin's); events {got}; max|Σ_active Δ| "
          f"after each sync {worst:.3e} <= {bound:.3e}; launches "
          f"{AJ_LAUNCHES} (twin {AJ_TWIN_LAUNCHES}); step wall "
          f"{1e3 * a.wall_s / 14:.1f} ms (twin {step_ms:.1f}); snapshot "
          f"{['%.3f' % x for x in ela['snapshot_s']]} s, rollback "
          f"{['%.3f' % x for x in ela['rollback_s']]} s, membership repair "
          f"{['%.3f' % x for x in ela['membership_s']]} s; peak "
          f"{peak / 2**30:.2f} GiB (round peak {a.round_peak_bytes / 2**30:.2f}"
          f"; the twin's {twin_peak / 2**30:.2f}, the faulted run's final "
          f"state held); {card}", flush=True)
    # the dead rows are never read: NaN planted in a dropped worker's
    # params and Δ, one more round, the survivors finite
    args = launch.parse_args(AJ_ARGS)
    cfg = qwen_cut()
    vrl = launch.vrl_config(args, membership=True)
    bundle = make_train_step(cfg, vrl, remat=True, device=dev)
    state, eng = a.state, bundle.engine
    del a
    mask = np.array([1, 0, 1, 1], np.float32)
    t0 = time.perf_counter()
    state = eng.set_membership(state, mask)
    torch.cuda.synchronize()
    repair_s = time.perf_counter() - t0
    s_drop, d_drop = active_sum(state)
    state.params[1].fill_(float("nan"))
    state.delta[1].fill_(float("nan"))
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (2, 4, 8, 64))).to(dev)
    state, losses = bundle.round_step(state, toks, torch.roll(toks, -1, -1))
    finite = all(bool(torch.isfinite(state.params[i]).all())
                 for i in (0, 2, 3))
    if not (finite and bundle.health(state, losses.mean())
            and torch.isfinite(losses).all()):
        raise AssertionError("(aj): a dead worker's NaN reached a survivor")
    xhat = state.params[0].clone()
    state = eng.set_membership(state, np.ones(4, np.float32))
    s_join, d_join = active_sum(state)
    # the rejoiner starts at the continuing rows' mean (3 x̂ / 3: within
    # an ulp of x̂)
    ulp = float(np.spacing(np.float32(torch.linalg.vector_norm(
        xhat, float("inf")).item())))
    off = torch.linalg.vector_norm(state.params[1] - xhat,
                                   float("inf")).item()
    if not (off <= ulp and torch.isfinite(state.params).all()
            and s_drop <= 1e-4 * d_drop + bound
            and s_join <= 1e-4 * d_join + bound):
        raise AssertionError(f"(aj): the repairs' Σ Δ {s_drop}, {s_join}")
    del state, bundle, eng
    free()
    # the full mask: 4 steps with --membership bitwise 4 steps without
    finals = []
    for member in (True, False):
        vrl = launch.vrl_config(launch.parse_args(AJ_FULL),
                                membership=member)
        bundle = make_train_step(cfg, vrl, remat=True, device=dev)
        state = bundle.init_state(0, 4)
        ls = []
        for r in range(2):
            state, losses = bundle.round_step(state, toks,
                                              torch.roll(toks, -1, -1))
            ls.append(losses)
        finals.append((state, torch.cat(ls)))
        del bundle
    (s1, l1), (s0, l0) = finals
    if not (torch.equal(l1, l0) and torch.equal(s1.params, s0.params)
            and torch.equal(s1.delta, s0.delta)):
        raise AssertionError("(aj): the full mask is not membership off")
    del finals, s1, s0
    free()
    print(f"[10 elastic (aj)] worker 1 dropped (repair {repair_s:.3f} s, "
          f"max|Σ_active Δ| {s_drop:.3e}), NaN planted in its params and "
          f"Δ, a round: survivors finite, health True, losses "
          f"{['%.4f' % x for x in losses.tolist()]}; rejoined from x̂ "
          f"(max|Σ Δ| {s_join:.3e}); 4 steps with membership on bitwise "
          f"off (losses, params, Δ); {card}", flush=True)


def elastic_clients(dev, vu, card, launch):
    """(ak): M = 4 over W = 2 at full width; M = W bitwise storeless."""
    from repro_torch.core.clients import sample_cohort
    free()
    torch.cuda.reset_peak_memory_stats()
    vu.reset_launches()
    with counting_means() as counts:
        k = launch.run(AK_ARGS)
    peak = torch.cuda.max_memory_allocated()
    check_launches("(ak)", dict(vu.LAUNCHES),
                   {"fused_local_sgd": 6, "fused_sync_vrl": 3})
    if counts.get("state") != 3:
        raise AssertionError(f"(ak): model-state means {counts}, one a "
                             f"round expected")
    if not all(math.isfinite(x) for x in k.losses + k.avg_model_losses):
        raise AssertionError(f"(ak): non-finite loss {k.losses}")
    store, ela = k.store, k.elastic
    # Σ Δ over a gathered cohort after the recentre
    eng = k.engine
    cohort = sample_cohort(4, 2, 6, 0)
    st = eng.recenter_drift(store.gather(cohort, like=k.state,
                                         seed_params=True))
    s = torch.linalg.vector_norm(st.delta.sum(0), float("inf")).item()
    d = torch.linalg.vector_norm(st.delta, float("inf")).item()
    ulp = float(np.spacing(np.float32(torch.linalg.vector_norm(
        st.params, float("inf")).item())))
    if not s <= 1e-4 * d + 2 * 2 * ulp / (2 * MAIN_LR):
        raise AssertionError(f"(ak): Σ Δ {s} over the gathered cohort")
    nbytes, pinned = store.nbytes, store.pin
    del k, store, st
    free()
    vu.reset_launches()
    mw = launch.run(AK_MW)
    plain = launch.run(AK_PLAIN)
    if mw.losses != plain.losses or not (
            torch.equal(mw.state.params, plain.state.params)
            and torch.equal(mw.state.delta, plain.state.delta)):
        raise AssertionError(f"(ak): M = W {mw.losses} is not the "
                             f"storeless run {plain.losses}")
    del mw, plain
    free()
    print(f"[10 elastic (ak)] qwen2-0.5b, --clients 4 over W = 2 "
          f"(participation 0.5), 6 steps: host store {nbytes / 1e9:.3f} GB "
          f"({'page-locked' if pinned else 'pageable'}), gather {['%.3f' % x for x in ela['gather_s']]} s "
          f"and scatter {['%.3f' % x for x in ela['scatter_s']]} s a round; "
          f"model-state means {counts}; after a gather and recentre "
          f"max|Σ Δ| {s:.3e} (max|Δ| {d:.3e}); peak {peak / 2**30:.2f} GiB; "
          f"--clients 2 (M = W) bitwise the storeless run for 2 rounds "
          f"(losses, params, Δ); {card}", flush=True)


def elastic_smoke(dev, vu, card, cpu):
    """(al): the smoke runs on the card against the CPU's; the client run
    resumed bitwise from its step-4 store."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.launch import train as launch
    vu.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        card_runs = al_runs("cuda", ELASTIC_DIR)
    launches = {k: v for k, v in vu.LAUNCHES.items() if v}
    worst = {}
    for tag, want in cpu.items():
        if tag == "seconds":
            continue
        got = card_runs[tag]
        pairs = ([(got[k], want[k]) for k in ("losses", "avg")]
                 if tag != "quickstart" else
                 [(got[k], want[k]) for k in want])
        for g, w in pairs:
            g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
            rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-30)
            worst[tag] = max(worst.get(tag, 0.0), float(rel.max()))
            if g.shape != w.shape or not np.isfinite(g).all() or \
                    not rel.max() <= 1e-4:
                raise AssertionError(f"(al) {tag}: card {g.tolist()} vs CPU "
                                     f"{w.tolist()} (rtol {rel.max():.3e})")
        if tag != "quickstart" and json.loads(json.dumps(
                got["masks"])) != want["masks"]:
            raise AssertionError(f"(al) {tag}: masks {got['masks']}")
    for name in ("fused_fold_overlap_hier2", "fused_ef_int8_grid",
                 "fused_hier_local_sgd", "fused_sync_hier1",
                 "fused_sync_hier2", "fused_local_sgd", "fused_sync_vrl"):
        if not launches.get(name):
            raise AssertionError(f"(al): {name} not launched: {launches}")
    root = os.path.join(ELASTIC_DIR, "cuda", "clients")
    res = launch.run(AL_CLIENTS + ["--ckpt", os.path.join(ELASTIC_DIR, "b"),
                                   "--resume", ckpt.step_dir(root, 4)])
    if res.losses != card_runs["clients"]["losses"][4:]:
        raise AssertionError(f"(al): resumed {res.losses} vs "
                             f"{card_runs['clients']['losses'][4:]}")
    nbytes = same_checkpoint("(al) clients step 8", ckpt.step_dir(root, 8),
                             ckpt.step_dir(os.path.join(ELASTIC_DIR, "b"), 8))
    print(f"[10 elastic (al)] smoke, card vs CPU (its runs took "
          f"{cpu['seconds']:.1f} s beside (aj)-(ak)): hier (2, 2) + int8 "
          f"with a pod drop and a worker drop, overlapped and blocking; "
          f"--clients 8 --workers 4 with crash/rejoin/killsave: every loss "
          f"within 1e-4; the quickstart ({AL_QUICKSTART}): every loss "
          f"within 1e-4; "
          f"worst relative loss differences "
          f"{ {k: '%.2e' % v for k, v in worst.items()} }; launches "
          f"{launches}; the client run resumed from its step-4 store: "
          f"steps 5-8 and the step-8 store ({nbytes / 1e6:.1f} MB) bitwise; "
          f"{card}", flush=True)


def elastic_phase(dev, vu, card) -> None:
    """Phase 10: (aj), (ak), (al); the directory removed at the end."""
    from repro_torch.launch import train as launch
    t10 = time.time() - START
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    os.makedirs(ELASTIC_DIR)
    print(f"[10 elastic] from {t10:.1f} s of the script, the smoke runs' "
          f"CPU twins in a child process beside (aj) and (ak); {card}",
          flush=True)
    proc = start_elastic_cpu()
    try:
        elastic_full_width(dev, vu, card, launch)
        elastic_clients(dev, vu, card, launch)
        cpu = paper_cpu_result(*proc, what="(al)'s CPU runs")
        elastic_smoke(dev, vu, card, cpu)
    finally:
        if proc[0].poll() is None:
            proc[0].kill()
            proc[0].wait()
        shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    print(f"[10 elastic] {time.time() - START - t10:.1f} s; the script "
          f"{time.time() - START:.1f} s", flush=True)


# ---------------------------------------------------------------- phase 11
# the hybrid and MoE families (``models/hybrid.py``, ``models/moe.py``)
PHI = "phi3.5-moe-42b-a6.6b"
KIMI = "kimi-k2-1t-a32b"
FAMILIES = (HYMBA, PHI, KIMI)
# (am): hymba-1.5b served at full depth through the serve CLI; a prompt
# past the 1024-slot attention window and four 256-token SSM chunks
AM_ARGS = ["--batch", "4", "--prompt-len", "1040", "--gen", "32"]
# (an): hymba-1.5b trained at full depth through launch.train, W = 2, at
# (aj)'s γ: under the reference's init the first gradients at 32 layers
# reach ~1e6 (the smoke width at 32 layers on the CPU: losses ~250 after
# 4 steps at γ 1e-5, 6.25 at 1e-7)
AN_LR = 1e-7
AN_ARGS = ["--arch", HYMBA, "--workers", "2", "--batch", "8", "--seq", "64",
           "--steps", "4", "--k", "2", "--lr", str(AN_LR), "--log-every",
           "1"]
FAMILY_SERVE = (4, 32, 32)      # (ao), (aq): batch, prompt, generated
PHI_SERVE_LAYERS = 4            # of 32: 21.8 GB of fp32 weights
PHI_TRAIN_LAYERS = 1            # W = 2: params, Δ, gradients 37.5 GB
PHI_TRAIN_LAYOUT = (1_562_980_352, 6_106_112, 256)
KIMI_LAYERS = 1                 # of 61, bf16: 38.8 GB of weights
KIMI_PARAMS = 19_422_663_680
# (aq): layer 0's bf16 MoE output against the fp32 evaluation of its kept
# (token, expert) pairs from the same bf16 weights, per token within this
# share of the token's max|reference| (bf16 keeps 8 bits: four of its
# ulps at the row's scale)
KIMI_TOL = 2 ** -5
FAMILY_SMOKE_STEPS = (1, 2, 2, 2)   # (ar): k = 2 with warm-up, 7 steps
FAMILY_SMOKE_LAUNCHES = {"fused_local_sgd": 7, "fused_sync_vrl": 4}


def families_smoke(where, forced=None) -> dict:
    """(ar)'s runs of the three smoke variants on ``where``, each from the
    CPU's draws (seed 0) with wq, wk × 0.1 (the train slice's parity, as
    phase 5's): prefill logits and cache over a (3, 40) prompt (hymba's
    40 tokens: a padded second SSM chunk); 16 greedy tokens; the decode
    logits of 15 steps teacher-forced over ``forced[arch]`` (the CPU's
    tokens; its own when None) and their top-2 margins; and vrl_sgd + sgd,
    W = 2, batch 2 × seq 40, rounds of 1, 2, 2, 2 (losses, params, Δ and
    the launches).  Returns {arch: {name: array}}."""
    from repro_torch import tree as tm
    from repro_torch.configs import registry
    from repro_torch.configs.base import VRLConfig
    from repro_torch.data import assigned_token_stream, contiguous_assignment
    from repro_torch.kernels import vrl_update as vu
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    from repro_torch.train.train_loop import make_train_step
    out = {}
    for arch in FAMILIES:
        cfg = registry.smoke_arch(arch)
        params = T.init_params(cfg, seed=0)
        attn = attention_tree(params)
        attn["wq"], attn["wk"] = attn["wq"] * 0.1, attn["wk"] * 0.1
        p = tm.tree_map(lambda x: x.to(where), params)
        prompt = torch.randint(0, cfg.vocab_size, (3, 40),
                               generator=torch.Generator().manual_seed(4))
        r = {}
        with torch.no_grad():
            logits, cache = T.prefill(cfg, p, prompt.to(where), 64)
        r["prefill"] = logits.cpu().numpy()
        for path, leaf in tm.leaves_with_path(cache):
            r["cache/" + path] = leaf.float().cpu().numpy()
        eng = Engine(cfg, p, max_len=64, device=where)
        r["tokens"] = eng.generate(prompt, 16).cpu().numpy()
        toks = torch.from_numpy(r["tokens"] if forced is None
                                else forced[arch]).to(where)
        _, c = eng.prefill(prompt)
        steps = []
        for pos in range(40, 55):
            lg, c = eng.step(c, toks[:, pos:pos + 1], pos)
            steps.append(lg.cpu().numpy())
        r["decode"] = np.stack(steps)
        r["margins"] = decode_margins(eng, toks, 40)
        data = assigned_token_stream(contiguous_assignment(2, 2), 40,
                                     cfg.vocab_size,
                                     steps=sum(FAMILY_SMOKE_STEPS), batch=2,
                                     alpha=0.05, seed=0)
        bundle = make_train_step(cfg, VRLConfig(comm_period=2,
                                                learning_rate=LR,
                                                warmup=True), device=where)
        state = bundle.engine.init(p, 2)
        vu.reset_launches()
        losses, t = [], 0
        for rk in FAMILY_SMOKE_STEPS:
            x = torch.from_numpy(data[t:t + rk]).to(where).long()
            state, lk = bundle.round_step(state, x, torch.roll(x, -1, dims=-1))
            losses += lk.tolist()
            t += rk
        r["launches"] = {k: v for k, v in vu.LAUNCHES.items() if v}
        r.update(losses=np.array(losses), params=state.params.cpu().numpy(),
                 delta=state.delta.cpu().numpy())
        out[arch] = r
    return out


def families_cpu_runs(path: str) -> int:
    """The child process of phase 11: ``families_smoke`` on the CPU, its
    arrays into the npz ``path`` (keys "arch|name")."""
    torch.set_num_threads(3)
    t0 = time.time()
    runs = families_smoke("cpu")
    arrays = {f"{arch}|{k}": v for arch, r in runs.items()
              for k, v in r.items() if k != "launches"}
    np.savez(path, seconds=np.float64(time.time() - t0), **arrays)
    return 0


def start_families_cpu():
    """Start ``families_cpu_runs`` in a child process: (process, its npz
    path, its log path, its directory)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_families_")
    path, log = os.path.join(tmp, "cpu.npz"), os.path.join(tmp, "cpu.log")
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--families-cpu",
             path], stdout=subprocess.DEVNULL, stderr=err, cwd=ROOT)
    return proc, path, log, tmp


def families_cpu_result(proc, path, log) -> tuple:
    """Wait for the child (at most 600 s): ({arch: {name: array}}, its
    seconds)."""
    rc = proc.wait(timeout=600)
    if rc != 0:
        with open(log) as f:
            raise AssertionError(f"(ar)'s CPU runs failed ({rc}): "
                                 f"{f.read()[-3000:]}")
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            if key != "seconds":
                arch, name = key.split("|", 1)
                out.setdefault(arch, {})[name] = z[key]
        return out, float(z["seconds"])


def families_small_input(dev, card, cpu, cpu_s) -> None:
    """(ar): the card's ``families_smoke`` against the CPU's: prefill
    logits and every cache leaf, and the decode logits over the CPU's
    tokens, within atol 1e-4 (· max(1, max|leaf|) for the cache); the
    greedy tokens where the CPU's top-2 margin exceeds twice that; the
    losses within rtol 1e-4, params atol 1e-4, Δ atol 1e-4/(k γ); the
    flat engine's kernels on the card."""
    tol, k = 1e-4, 2
    card_runs = families_smoke(dev, {a: cpu[a]["tokens"] for a in FAMILIES})
    notes = []
    for arch in FAMILIES:
        want, got = cpu[arch], card_runs[arch]
        tag = f"(ar) {arch} smoke"
        close(torch.from_numpy(got["prefill"]),
              torch.from_numpy(want["prefill"]), tol, f"{tag} prefill")
        keys = sorted(n for n in want if n.startswith("cache/"))
        if keys != sorted(n for n in got if n.startswith("cache/")):
            raise AssertionError(f"{tag}: cache leaves {keys}")
        for n in keys:
            close(torch.from_numpy(got[n]), torch.from_numpy(want[n]),
                  tol * max(1.0, float(np.abs(want[n]).max())),
                  f"{tag} prefill {n}")
        close(torch.from_numpy(got["decode"]),
              torch.from_numpy(want["decode"]), tol, f"{tag} decode")
        compared = 0
        for row in range(want["tokens"].shape[0]):
            for i in range(16):
                if want["margins"][row, i] <= 2 * tol:
                    break               # either pick is right; they part
                if got["tokens"][row, 40 + i] != want["tokens"][row, 40 + i]:
                    raise AssertionError(f"{tag}: greedy token {i} of row "
                                         f"{row} differs")
                compared += 1
        check_launches(tag, got["launches"], FAMILY_SMOKE_LAUNCHES)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
        np.testing.assert_allclose(got["params"], want["params"], rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(got["delta"], want["delta"], rtol=0,
                                   atol=1e-4 / (k * LR))
        notes.append(
            f"{arch}: {len(keys)} cache leaves ({', '.join(n[6:] for n in keys)}),"
            f" {compared} greedy tokens equal, losses max rel diff "
            f"{np.abs(got['losses'] / want['losses'] - 1).max():.2e}, params "
            f"{np.abs(got['params'] - want['params']).max():.2e}, Δ "
            f"{np.abs(got['delta'] - want['delta']).max():.2e}")
    print(f"[11 families (ar)] smoke, card vs CPU (its runs took {cpu_s:.1f} "
          f"s beside (am)-(aq)), wq, wk × 0.1: prefill logits and cache, 15 "
          f"decode steps within atol {tol}; vrl_sgd+sgd 7 steps, launches "
          f"{FAMILY_SMOKE_LAUNCHES} each: {'; '.join(notes)}; {card}",
          flush=True)


def phi_serve(dev, card):
    """(ao) phi3.5-moe at full width, PHI_SERVE_LAYERS of its 32 layers
    (all 16 experts, top-2), fp32, through ``serve.Engine`` with the serve
    CLI's draws (weights seed 0, prompts seed 1), timed; then
    ``served_checks`` on an engine of the same weights whose capacity
    factor (E / k) drops nothing: a prefill of B·S tokens may drop (token,
    expert) entries that a decode step of B tokens keeps, so with drops
    the two compute different functions by design (the reference's
    capacity semantics)."""
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    cfg = dataclasses.replace(registry.get_arch(PHI),
                              num_layers=PHI_SERVE_LAYERS)
    b, s, gen = FAMILY_SERVE
    params = T.init_params(cfg, 0, device=dev)
    eng = Engine(cfg, params, max_len=s + gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    out, timings, wall, peak = timed_generate(eng, dev, prompt, gen)
    full = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)
    nd = Engine(full, params, max_len=s + gen, device=dev)
    with torch.no_grad():
        out_nd = nd.generate(prompt, gen)
    same = int((out_nd[:, s:] == out[:, s:]).sum())
    row = served_checks("(ao) serve.Engine",
                        f"{PHI} at {PHI_SERVE_LAYERS} of 32 layers (16 "
                        f"experts top-2; the checks at capacity factor "
                        f"{full.capacity_factor:g}, the served tokens "
                        f"{same} of {b * gen} equal to theirs)", cfg, nd,
                        prompt, out_nd, timings["prefill_ms"],
                        timings["decode_ms"], wall, peak, "11 families", card)
    del eng, nd, params, out, out_nd
    free()
    return row


def keep_mask(ids: np.ndarray, cap: int) -> np.ndarray:
    """Which (token, expert) entries of ids (T, k) fit the capacity: the
    reference's stable sort and searchsorted, in numpy."""
    flat = ids.reshape(-1)
    order = np.argsort(flat, kind="stable")
    srt = flat[order]
    pos = np.arange(flat.size) - np.searchsorted(srt, srt, side="left")
    keep = np.empty(flat.size, bool)
    keep[order] = pos < cap
    return keep.reshape(ids.shape)


@torch.no_grad()
def kimi_moe_check(cfg, params, prompt) -> tuple:
    """Layer 0's MoE on the prefill of ``prompt``: its input (the prefill's
    own ops to there), the port's bf16 ``moe_mlp`` on it, and the fp32
    evaluation of each kept (token, expert) pair from the same bf16
    weights upcast, weighted by the router, plus the shared expert.
    Returns (worst per-token max|y − ref| / max|ref|, dropped entries,
    kept entries, the capacity)."""
    import torch.nn.functional as F
    from repro_torch import tree as tm
    from repro_torch.models import attention, moe
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import rms_norm
    lp = tm.tree_map(lambda a: a[0], params["layers"])
    b, s = prompt.shape
    x = T.embed_inputs(cfg, params, prompt)
    positions = torch.arange(s, device=x.device).expand(b, s)
    x = x + attention.attend_full(cfg, lp["attn"],
                                  rms_norm(x, lp["norm1"], cfg.norm_eps),
                                  positions, window=cfg.attn_window)
    h = rms_norm(x, lp["norm2"], cfg.norm_eps).reshape(b * s, -1)
    pm = lp["moe"]
    y, _ = moe.moe_mlp(cfg, pm, h)
    w, ids, _ = moe.route(cfg, pm["router"], h)
    ids_np = ids.cpu().numpy()
    cap = moe.capacity(cfg, b * s)
    keep = keep_mask(ids_np, cap)
    hf = h.float()
    ref = torch.zeros_like(hf)
    for e in np.unique(ids_np[keep]):
        rows, js = (torch.from_numpy(a).to(h.device)
                    for a in np.nonzero(keep & (ids_np == e)))
        xe = hf[rows]
        he = F.silu(xe @ pm["w_gate"][e].float()) * (xe @ pm["w_up"][e].float())
        ref[rows] += w[rows, js, None] * (he @ pm["w_down"][e].float())
    hs = F.silu(hf @ pm["shared_w_gate"].float()) * (
        hf @ pm["shared_w_up"].float())
    ref += hs @ pm["shared_w_down"].float()
    ratio = ((y.float() - ref).abs().amax(-1) / ref.abs().amax(-1)).max()
    return ratio.item(), int((~keep).sum()), int(keep.sum()), cap


def kimi_serve(dev, card):
    """(aq) kimi-k2 at full width, KIMI_LAYERS of its 61 layers (all 384
    experts top-8, the shared expert, head_dim 112, the untied 163,840-row
    head), bf16 weights drawn on the card (the init scales each fp32 draw
    in place, so its peak holds one fp32 copy of the largest leaf, 22.5 GB,
    beside its bf16 cast and the leaves before it), through
    ``serve.Engine``: the output's shape, prompt and token range, finite
    prefill logits, the tree's count; then ``kimi_moe_check`` within
    KIMI_TOL."""
    from repro_torch import tree as tm
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    cfg = dataclasses.replace(registry.get_arch(KIMI), num_layers=KIMI_LAYERS)
    free()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = T.init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n_params = sum(x.numel() for x in tm.leaves(params))
    if n_params != KIMI_PARAMS:
        raise AssertionError(f"path (aq): {n_params} parameters")
    b, s, gen = FAMILY_SERVE
    eng = Engine(cfg, params, max_len=s + gen, device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    out, timings, wall, peak = timed_generate(eng, dev, prompt, gen)
    if out.shape != (b, s + gen) or not torch.equal(out[:, :s], prompt) or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"path (aq): output {tuple(out.shape)}")
    logits, _ = eng.prefill(prompt)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("path (aq): a non-finite prefill logit")
    ratio, dropped, kept, cap = kimi_moe_check(cfg, params, prompt)
    if not ratio <= KIMI_TOL:
        raise AssertionError(f"path (aq): layer 0's MoE {ratio:.3e} · "
                             f"max|ref| from its fp32 evaluation (limit "
                             f"{KIMI_TOL})")
    per_tok = float(np.mean(timings["decode_ms"]))
    nbytes = sum(x.numel() * x.element_size() for x in tm.leaves(params))
    weights_ms = 1e3 * nbytes / HBM_BW
    row = dict(tag="(aq) serve.Engine", prefill_ms=timings["prefill_ms"],
               decode_ms=per_tok, tok_s=b * gen / wall,
               peak_gib=peak / 2 ** 30, weights_ms=weights_ms)
    print(f"[11 families (aq)] {KIMI} at {KIMI_LAYERS} of 61 layers, bf16, "
          f"{n_params} parameters: init {init_s:.1f} s, its peak "
          f"{init_peak:.2f} GiB; batch {b}: prefill "
          f"{timings['prefill_ms']:.3f} ms ({b} x {s} tokens), decode "
          f"{per_tok:.3f} ms per token ({gen - 1} steps, "
          f"{min(timings['decode_ms']):.3f}-{max(timings['decode_ms']):.3f};"
          f" the weights' {nbytes / 1e9:.2f} GB take {weights_ms:.3f} ms at "
          f"3.35 TB/s), {row['tok_s']:.1f} tokens/s batched, peak "
          f"{row['peak_gib']:.2f} GiB; no kernel launched; layer 0's MoE on "
          f"the prefill ({kept} (token, expert) entries kept, {dropped} "
          f"dropped at capacity {cap}) within {ratio:.3e} · max|ref| of its "
          f"fp32 evaluation per token (limit {KIMI_TOL:.4f}); {card}",
          flush=True)
    del eng, params, out, logits
    free()
    return row


def phi_train(dev, vu, card) -> dict:
    """(ap) phi3.5-moe at full width, PHI_TRAIN_LAYERS layer, through
    ``make_train_step`` and ``round_step``: vrl_sgd + sgd, W = 2, batch 8
    × seq 64 (512 tokens a worker: capacity 80 an expert), k = 2, 4 steps
    (fused_local_sgd 4, fused_sync_vrl 2), Σ Δ as phase 4 holds it; then
    (ar)'s twin: its first round run twice more from the same seed, each
    on a fresh engine, bitwise equal in losses, params and Δ (the
    dispatch's permutation, with no colliding scatter of nonzeros)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import VRLConfig
    from repro_torch.data import assigned_token_stream, contiguous_assignment
    from repro_torch.models import moe
    from repro_torch.train.train_loop import make_train_step
    cfg = dataclasses.replace(registry.get_arch(PHI),
                              num_layers=PHI_TRAIN_LAYERS)
    vrl_kw = dict(comm_period=2, warmup=False, learning_rate=MAIN_LR)
    res = train_path("(ap) phi3.5-moe vrl_sgd+sgd", vrl_kw, TRAIN8_ROUNDS,
                     TRAIN8_LAUNCHES, dev, vu, cfg=cfg, w=2)
    print_path(res, f"; {check_sums(res)}; all 16 experts top-2, capacity "
               f"{moe.capacity(cfg, 8 * 64)} an expert; {card}",
               phase="11 families")
    data = assigned_token_stream(contiguous_assignment(2, 2), 64,
                                 cfg.vocab_size, steps=2, batch=8,
                                 alpha=0.05, seed=0)
    toks = torch.from_numpy(data).to(dev, torch.long)
    runs = []
    for _ in range(2):
        bundle = make_train_step(cfg, VRLConfig(**vrl_kw), device=dev)
        spec = bundle.engine.spec
        if (spec.size, spec.rows, spec.lanes) != PHI_TRAIN_LAYOUT:
            raise AssertionError(f"path (ap): flat layout {spec.meta()}")
        state = bundle.init_state(0, 2)
        state, lk = bundle.round_step(state, toks,
                                      torch.roll(toks, -1, dims=-1))
        runs.append((lk.tolist(), state.params, state.delta))
        del bundle, state
        free()
    (l0, p0, d0), (l1, p1, d1) = runs
    if not (l0 == l1 and torch.equal(p0, p1) and torch.equal(d0, d1)):
        raise AssertionError(f"(ar) twin: two card runs of (ap)'s first "
                             f"round differ: losses {l0} vs {l1}")
    print(f"[11 families (ar)] twin: (ap)'s first round run twice more on "
          f"the card, each from seed 0 on a fresh engine: losses {l0}, "
          f"params ({p0.numel()} elements) and Δ bitwise equal; {card}",
          flush=True)
    del runs, p0, p1, d0, d1
    free()
    return res


def families_phase(dev, vu, card) -> None:
    """Phase 11: (am)-(aq) on the card, (ar) against the CPU's runs of a
    child process started at the phase's start."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import train as launch
    t11 = time.time() - START
    print(f"[11 families] from {t11:.1f} s of the script, the smoke "
          f"variants' CPU runs in a child process beside (am)-(aq); {card}",
          flush=True)
    free()
    proc, path, log, tmp = start_families_cpu()
    try:
        serve_path("(am) serve", HYMBA, vu, fa, ss, AM_ARGS, "11 families",
                   card)
        for fn in (phi_serve, kimi_serve):
            for mod in (vu, fa, ss):
                mod.reset_launches()
            row = fn(dev, card)
            check_launches(row["tag"], {**vu.LAUNCHES, **fa.LAUNCHES,
                                        **ss.LAUNCHES}, {})
        cli_path(f"(an) {HYMBA} vrl_sgd+sgd", AN_ARGS, TRAIN8_LAUNCHES,
                 launch, vu, rounding=True, phase="11 families")
        phi_train(dev, vu, card)
        cpu, cpu_s = families_cpu_result(proc, path, log)
        families_small_input(dev, card, cpu, cpu_s)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[11 families] {time.time() - START - t11:.1f} s; the script "
          f"{time.time() - START:.1f} s", flush=True)


# ---------------------------------------------------------------- phase 12
# Row shards on a rank grid, the shard-mapped MoE and the chaos check.  NCCL
# refuses two ranks on one card, so the (data, shard) and (data, model)
# grids run over gloo through host memory, as (z2) and (z3) do.
SHARD_LAYERS = 4                # (as): qwen2-0.5b at 4 of its 24 layers
SHARD_WORLD = 4                 # (as)-(au): data 2 x shard (model) 2
AS_STEPS = 2                    # one round (cut from 4, the script's time)
AS_ARGS = ["--arch", "qwen2-0.5b", "--layers", str(SHARD_LAYERS),
           "--workers", "2", "--batch", "8", "--seq", "64", "--steps",
           str(AS_STEPS),
           "--k", "2", "--lr", str(MAIN_LR), "--inner-optimizer", "adam",
           "--log-every", "1"]
AS_LAUNCHES = {"fused_local_adam": 2, "fused_sync_vrl": 1}
AT_ARGS = ["--arch", "qwen2-0.5b", "--smoke", "--workers", "2", "--batch",
           "2", "--seq", "32", "--steps", "8", "--k", "2", "--lr", str(LR),
           "--inner-optimizer", "adam", "--sm3", "--moment-dtype",
           "bfloat16", "--compress", "int8", "--overlap", "--faults",
           "crash@1:3,rejoin@1:5", "--log-every", "1", "--ckpt-every", "4",
           "--shards", "2"]
# (bl): the client store on row shards, 2 rounds of k = 1 with a save
# after the second; a rank's store 3.1 GB of page-locked host memory; one
# log line, at the end (each logged round evaluates x̂ through gloo)
BL_ARGS = ["--arch", "qwen2-0.5b", "--layers", str(SHARD_LAYERS),
           "--workers", "2", "--clients", "4", "--participation", "0.5",
           "--batch", "2", "--seq", "64", "--steps", "2", "--k", "1",
           "--lr", str(MAIN_LR), "--log-every", "2", "--shards", "2",
           "--ckpt-every", "2"]
BL_LAUNCHES = {"fused_local_sgd": 2, "fused_sync_vrl": 2}
BL_TIMEOUT = 600
# (au): phi3.5-moe's published widths, 16 experts top-2, no shared experts,
# fp32, capacity factor E / k (no drop); 256 tokens a data rank
AU_TOKENS = 512
AU_SEED = 0
AU_RTOL = 1e-5                  # × max|ref|: fp32 rounding, not TF32
AU_TIMEOUT = 600


def shard_cli(tag, argv, card, world=SHARD_WORLD) -> list:
    """``launch.train --mesh-grid`` under the launcher at gloo ``world``:
    each rank's JSON (and the log), its backend and device checked, its
    step wall, spans, collectives by kind and group, kernel launches and
    round peak printed."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    out, log = os.path.join(tmp, "out.json"), os.path.join(tmp, "log.txt")
    ranks = ranks_result(tag, start_ranks(argv, world, out, log), out, log,
                         world)
    shutil.rmtree(tmp, ignore_errors=True)
    lines = ranks[0]["log"].splitlines()
    for head in ("mesh: ", "engine: "):
        print(f"[12 shards {tag}] "
              f"{next(x for x in lines if x.startswith(head))}", flush=True)
    for r, res in enumerate(ranks):
        if (res["backend"], res["device"]) != ("gloo", "cuda:0"):
            raise AssertionError(f"{tag}: rank {r} ran {res['backend']} on "
                                 f"{res['device']}")
        spans = {k: [round(x, 1) for x in v]
                 for k, v in res["phases_ms"].items()}
        print(f"[12 shards {tag}] rank {r}: step wall "
              f"{1e3 * res['wall_s'] / max(len(res['losses']), 1):.1f} ms; "
              f"spans (device ms) {json.dumps(spans)}; collectives "
              f"{json.dumps(res['collectives'])}; launches "
              f"{ {k: v for k, v in res['kernels'].items() if v} }; round "
              f"peak {res['round_peak_bytes'] / 2**30:.2f} GiB", flush=True)
    return ranks


def same_ranks(tag, ranks, one, launches) -> None:
    """Every rank's losses, averaged-model losses and kernel launches
    those of the one-process run ``one`` (with its ``launches``)."""
    for r, res in enumerate(ranks):
        if (res["losses"], res["avg_model_losses"]) != (
                one.losses, one.avg_model_losses):
            raise AssertionError(f"{tag}: rank {r} losses {res['losses']} "
                                 f"vs one process {one.losses}")
        check_launches(f"{tag} rank {r}", res["kernels"], launches)


def as_path(vu, card, launch) -> None:
    """(as): qwen2-0.5b at ``SHARD_LAYERS`` layers, full width, vrl_sgd +
    adam through ``launch.train --mesh-grid --shards 2`` on gloo (data 2 ×
    shard 2), against the one-process runs at --shards 2 (bitwise: the
    losses; the sharded save's gather is (at)'s) and 1 (1e-6 ·
    max|p|)."""
    from repro_torch.core import flat
    _, rows, lanes = QWEN_CUT_LAYOUTS[SHARD_LAYERS]
    t0 = time.time()
    ranks = shard_cli("(as)", AS_ARGS + ["--shards", "2"], card)
    t_mesh = time.time() - t0
    vu.reset_launches()
    one = launch.run(AS_ARGS + ["--shards", "2"])
    check_launches("(as) one process", dict(vu.LAUNCHES), AS_LAUNCHES)
    same_ranks("(as)", ranks, one, AS_LAUNCHES)
    # rows pad to a multiple of block · shards: 765,952 at block 1024
    block = [1, one.engine.spec.rows // 2, lanes]
    rounds = len(one.losses) // 2
    for r, res in enumerate(ranks):
        if res["state_shapes"]["params"] != block:
            raise AssertionError(f"(as): rank {r} params block "
                                 f"{res['state_shapes']['params']}, "
                                 f"expected {block}")
        state = {g: (c["calls"], c["async"])
                 for g, c in res["collectives"]["state"].items()}
        if state != {"pod+data": (rounds, 0)}:
            raise AssertionError(f"(as): rank {r} model-state all-reduces "
                                 f"{state}: one a round over its shard "
                                 f"column expected")
        limit, max_d = ckpt_bound(types.SimpleNamespace(**res))
        worst = max(s for _, s, _ in res["invariant"])
        if not (len(res["invariant"]) == rounds and worst <= limit):
            raise AssertionError(f"(as): rank {r} Σ_i Δ_i {res['invariant']}"
                                 f" against {limit}")
    one1 = launch.run(AS_ARGS)
    a, b = (tm_leaves(flat.unflatten_stacked(r.engine.spec, r.state.params))
            for r in (one, one1))
    scale = max(amax(x) for x in b)
    diff = max(amax(x - y) for x, y in zip(a, b))
    if not diff <= 1e-6 * scale:
        raise AssertionError(f"(as): shards 2 vs 1 max|Δp| {diff} > 1e-6 · "
                             f"{scale}")
    fwd = ranks[0]["collectives"]["forward"]["shard"]
    walls = ", ".join("%.1f" % (1e3 * r["wall_s"] / len(r["losses"]))
                      for r in ranks)
    peaks = ", ".join("%.2f" % (r["round_peak_bytes"] / 2**30) for r in ranks)
    print(f"[12 shards (as)] qwen2-0.5b at {SHARD_LAYERS} of 24 layers "
          f"(flat {rows:,} x {lanes}; {one.engine.spec.rows:,} rows at "
          f"--shards 2), W = 2, vrl_sgd+adam: the four ranks' "
          f"losses {['%.6f' % x for x in one.losses]} bitwise the "
          f"one-process run at --shards 2 (each rank "
          f"{block}, one state all-reduce a round over its shard column, "
          f"launches {AS_LAUNCHES} as one process); --shards 1 within "
          f"{diff:.3e} <= 1e-6 · max|p| {scale:.3e}; Σ_i Δ_i within "
          f"{worst:.3e} after every sync; the rows' all-gather "
          f"{fwd['bytes'] / fwd['calls'] / 1e6:.1f} MB a rank a step "
          f"({fwd['calls']} calls); step wall: gloo ranks {walls} ms, one "
          f"process {1e3 * one.wall_s / len(one.losses):.1f} ms "
          f"(shards 2), {1e3 * one1.wall_s / len(one1.losses):.1f} ms "
          f"(shards 1); round peak: ranks {peaks} GiB, one process "
          f"{one.round_peak_bytes / 2**30:.2f} GiB; the launch "
          f"{t_mesh:.1f} s; {card}", flush=True)
    del one, one1, a, b
    free()


def at_path(vu, card, launch) -> None:
    """(at): the smoke width with SM3 Adam, bf16 mu, int8, overlap and a
    crash/rejoin on gloo (data 2 × shard 2): the run and its save bitwise
    the one-process run at --shards 2, and the run resumed from its
    step-4 save bitwise its uninterrupted steps 5-8."""
    from repro_torch import checkpoint as ckpt
    tmp = tempfile.mkdtemp(prefix="chip_smoke_at_")
    da, db, d1 = (os.path.join(tmp, n) for n in ("mesh", "resumed", "one"))
    try:
        full = shard_cli("(at) uninterrupted", AT_ARGS + ["--ckpt", da],
                         card)
        res = shard_cli("(at) resumed", AT_ARGS + [
            "--ckpt", db, "--resume", ckpt.step_dir(da, 4)], card)
        vu.reset_launches()
        one = launch.run(AT_ARGS + ["--ckpt", d1])
        launches = {k: v for k, v in vu.LAUNCHES.items() if v}
        same_ranks("(at)", full, one, launches)
        nbytes = sum(same_checkpoint(f"(at) step {t}", ckpt.step_dir(da, t),
                                     ckpt.step_dir(d1, t)) for t in (4, 8))
        nbytes += same_checkpoint("(at) resumed step 8",
                                  ckpt.step_dir(db, 8), ckpt.step_dir(da, 8))
        for r, (a, b) in enumerate(zip(full, res)):
            if b["losses"] != a["losses"][4:]:
                raise AssertionError(f"(at): rank {r} resumed losses "
                                     f"{b['losses']} vs {a['losses'][4:]}")
        print(f"[12 shards (at)] smoke qwen2-0.5b W = 2, adam+sm3, bf16 mu, "
              f"int8, overlap, crash@1:3 / rejoin@1:5 at --shards 2: the "
              f"ranks' losses {['%.4f' % x for x in one.losses]}, launches "
              f"{launches} bitwise one process's; the step-4 and step-8 "
              f"saves bitwise one process's, the resumed run's step-8 save "
              f"and losses bitwise the uninterrupted run's "
              f"({nbytes / 1e6:.2f} MB compared); {card}",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def au_config():
    """phi3.5-moe's widths, no shared experts, capacity factor E / k."""
    from repro_torch.configs import registry
    cfg = registry.get_arch("phi3.5-moe-42b-a6.6b")
    return dataclasses.replace(
        cfg, num_shared_experts=0,
        capacity_factor=cfg.num_experts / cfg.experts_per_token)


def au_inputs(cfg, dev) -> tuple:
    """The layer's whole fp32 weights and the (T, d) tokens, drawn on the
    card from ``AU_SEED`` (the same on every rank)."""
    g = torch.Generator(device=dev).manual_seed(AU_SEED)
    d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts

    def draw(shape, scale):
        return torch.randn(shape, generator=g, device=dev) * scale
    p = {"router": draw((d, e), d ** -0.5),
         "w_gate": draw((e, d, ff), d ** -0.5),
         "w_up": draw((e, d, ff), d ** -0.5),
         "w_down": draw((e, ff, d), ff ** -0.5)}
    return p, draw((AU_TOKENS, d), 1.0)


def moe_rank_run(out: str) -> int:
    """(au)'s rank, under ``torch.distributed.run`` (gloo): the layer's
    blocks on a (data 2 × model 2) grid, two calls (bitwise run to run),
    its output gathered to rank 0, which runs ``moe.moe_mlp`` on the
    whole weights and tokens; a JSON per rank."""
    import torch.distributed as dist
    from repro_torch.comm import collectives as coll
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe
    from repro_torch.models import moe_shardmap as ms
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo")
    mesh = mesh_mod.make_mesh((2, 2), ("data", "model"))
    rank, cfg = mesh.rank, au_config()
    p, x = au_inputs(cfg, dev)
    blocks = ms.shard_params(p, mesh)
    xl = ms.shard_tokens(x, mesh).contiguous()
    del p, x
    free()
    torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    with torch.no_grad():
        for _ in range(2):
            coll.reset_counts()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            y, aux = ms.moe_mlp_shardmap(cfg, blocks, xl, mesh)
            torch.cuda.synchronize(dev)
            runs.append((y, float(aux), 1e3 * (time.perf_counter() - t0),
                         json.loads(json.dumps(coll.COUNTS))))
        # the same call with TF32 products: what the limit must tell apart
        torch.backends.cuda.matmul.allow_tf32 = True
        y_tf32 = ms.moe_mlp_shardmap(cfg, blocks, xl, mesh)[0].cpu()
        torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"rank": rank, "coords": mesh.index(("data", "model")),
           "bitwise": bool(torch.equal(runs[0][0], runs[1][0])
                           and runs[0][1] == runs[1][1]),
           "ms": [r[2] for r in runs], "counts": runs[0][3],
           "aux": runs[0][1],
           "peak": torch.cuda.max_memory_allocated(dev),
           "stored_bytes": sum(blocks[k].numel() * 4
                               for k in ("w_gate", "w_up", "w_down"))}
    y = runs[0][0].cpu()
    del runs, blocks
    free()
    parts = [torch.empty_like(y) for _ in range(4)] if rank == 0 else None
    dist.gather(y, parts, dst=0)
    parts_tf32 = ([torch.empty_like(y) for _ in range(4)] if rank == 0
                  else None)
    dist.gather(y_tf32, parts_tf32, dst=0)
    if rank == 0:
        p, x = au_inputs(cfg, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.no_grad():
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            y_ref, aux_ref = moe.moe_mlp(cfg, p, x)
            torch.cuda.synchronize(dev)
        rec["ref_ms"] = 1e3 * (time.perf_counter() - t0)
        rec["ref_peak"] = torch.cuda.max_memory_allocated(dev)
        y_ref = y_ref.cpu()
        got = torch.cat([parts[0], parts[2]])      # data 0, data 1
        rec["models_agree"] = bool(torch.equal(parts[0], parts[1])
                                   and torch.equal(parts[2], parts[3]))
        rec["err"] = float((got - y_ref).abs().max())
        rec["err_tf32"] = float((torch.cat([parts_tf32[0], parts_tf32[2]])
                                 - y_ref).abs().max())
        rec["scale"] = float(y_ref.abs().max())
        rec["aux_ref"] = float(aux_ref)
    with open(f"{out}.rank{rank}", "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    return 0


def au_start():
    """(au)'s ranks under the launcher, started at the phase's start beside
    (as) and (at) (the ranks' start-up overlaps theirs) -> (process, JSON
    path, log path, directory, start time)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_au_")
    out, log = os.path.join(tmp, "out.json"), os.path.join(tmp, "log.txt")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(SHARD_WORLD), os.path.abspath(__file__),
             "--moe-ranks", out], stdout=f, stderr=subprocess.STDOUT,
            cwd=ROOT, env=env, start_new_session=True)
    return proc, out, log, tmp, time.time()


def au_path(card, run) -> None:
    """(au): ``moe_mlp_shardmap`` at phi3.5-moe's widths on gloo (data 2 ×
    model 2), 256 tokens a data rank, against ``moe.moe_mlp`` in one
    process on the same 512 tokens; ``run``: ``au_start``'s launch."""
    cfg = au_config()
    d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    whole = 3 * e * d * ff * 4
    proc, out, log, tmp, t0 = run
    try:
        rc = proc.wait(timeout=AU_TIMEOUT)
    except subprocess.TimeoutExpired:
        stop_ranks(proc)
        rc = "timeout"
    with open(log) as f:
        text = f.read()
    if rc != 0:
        raise AssertionError(f"(au): the ranks exited {rc}: {text[-4000:]}")
    ranks = [json.load(open(f"{out}.rank{r}")) for r in range(SHARD_WORLD)]
    shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    block = whole // SHARD_WORLD
    for r, rec in enumerate(ranks):
        # three weight gathers (this rank's blocks) and the aux mean over
        # "data", the output sum over "model"
        want = {"data": {"calls": 4, "bytes": block + 4, "async": 0},
                "model": {"calls": 1, "bytes": AU_TOKENS // 2 * d * 4,
                          "async": 0}}
        if rec["counts"] != {"moe": want}:
            raise AssertionError(f"(au): rank {r} collectives "
                                 f"{rec['counts']}, expected {want}")
        if not rec["bitwise"]:
            raise AssertionError(f"(au): rank {r} not bitwise run to run")
        if rec["stored_bytes"] != block:
            raise AssertionError(f"(au): rank {r} stores "
                                 f"{rec['stored_bytes']} B of weights")
        print(f"[12 shards (au)] rank {r} (data, model) {rec['coords']}: "
              f"{', '.join('%.1f' % x for x in rec['ms'])} ms a call "
              f"(two), collectives {json.dumps(rec['counts'])}, peak "
              f"{rec['peak'] / 2**30:.2f} GiB", flush=True)
    tol = AU_RTOL * r0["scale"]
    if not (r0["models_agree"] and r0["err"] <= tol):
        raise AssertionError(f"(au): max|y - moe_mlp| {r0['err']} > {tol}, "
                             f"or the model ranks' outputs differ")
    print(f"[12 shards (au)] phi3.5-moe widths (d {d}, moe_d_ff {ff}, {e} "
          f"experts top-{cfg.experts_per_token}, capacity factor "
          f"{cfg.capacity_factor:g}, fp32) on gloo (data 2 x model 2), "
          f"{AU_TOKENS // 2} tokens a data rank: max|y - moe_mlp| "
          f"{r0['err']:.3e} <= 1e-5 · max|ref| {tol:.3e} (the same call "
          f"with TF32 products {r0['err_tf32']:.3e}, "
          f"{'outside' if r0['err_tf32'] > tol else 'INSIDE'} the limit), "
          f"bitwise run to run; aux {r0['aux']:.6f} (mean over the data blocks) vs the "
          f"one-process {r0['aux_ref']:.6f} (over all 512 tokens); expert "
          f"weights {whole / 1e9:.2f} GB whole, {block / 1e9:.2f} GB a rank "
          f"stored, {2 * block / 1e9:.2f} GB gathered; moe_mlp in one "
          f"process {r0['ref_ms']:.1f} ms, peak {r0['ref_peak'] / 2**30:.2f} "
          f"GiB; the launch {time.time() - t0:.1f} s; {card}", flush=True)


def bl_start():
    """(bl)'s ranks under the launcher, started at the phase's start beside
    (au)'s -> (process, JSON path, log path, directory, checkpoint
    directory, start time)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bl_")
    out, log = os.path.join(tmp, "out.json"), os.path.join(tmp, "log.txt")
    ck = os.path.join(tmp, "ckpt")
    proc = start_ranks(BL_ARGS + ["--ckpt", ck], SHARD_WORLD, out, log)
    return proc, out, log, tmp, ck, time.time()


def bl_path(vu, card, launch, run) -> None:
    """(bl): the client store on row shards (``bl_start``'s ranks) against
    its twin, the same flags in one process on the card: losses and
    launches bitwise; every rank's row block of the store after each round
    bitwise the twin's block of it; a rank's store bytes and "clients"
    bytes 1/2 of the row-split ones; the ranks' save restored into the
    twin's layout bitwise the twin's store."""
    from repro_torch import checkpoint as ckpt
    from repro_torch import tree as tree_mod
    proc, out, log, tmp, ck, t0 = run
    try:
        ranks = ranks_result("(bl)", proc, out, log, SHARD_WORLD,
                             timeout=BL_TIMEOUT)
        t_ranks = time.time() - t0
        t1 = time.time()
        vu.reset_launches()
        twin_out = os.path.join(tmp, "twin.json")
        one = launch.run(BL_ARGS + ["--loss-out", twin_out])
        t_twin = time.time() - t1
        check_launches("(bl) twin", dict(vu.LAUNCHES), BL_LAUNCHES)
        same_ranks("(bl)", ranks, one, BL_LAUNCHES)
        twin = json.load(open(twin_out))
        rounds = len(twin["store_digests"])
        for r, res in enumerate(ranks):
            if len(res["store_digests"]) != rounds or rounds != 2:
                raise AssertionError(f"(bl): rank {r} hashed "
                                     f"{len(res['store_digests'])} stores, "
                                     f"the twin {rounds}")
            for i, (got, want) in enumerate(zip(res["store_digests"],
                                                twin["store_digests"])):
                for key, blocks in got.items():
                    w = want[key][0 if len(want[key]) == 1
                                  else res["shard"]]
                    if blocks != [w]:
                        raise AssertionError(
                            f"(bl): rank {r} (shard {res['shard']}) store "
                            f"{key} after round {i + 1} is not the twin's "
                            f"block")
        store = one.store
        split = whole = 0
        for _, leaf in tree_mod.state_leaves(store.to_tree()["clients"]):
            if isinstance(leaf, torch.Tensor) and leaf.dim() >= 2:
                split += leaf.numel() * leaf.element_size()
            else:
                whole += (leaf.numel() * leaf.element_size()
                          if isinstance(leaf, torch.Tensor) else 4)
        rows, lanes = one.state.params.shape[-2:]
        # params and Δ, one worker slot a worker rank, fp32: what a round's
        # scatter would all-gather on an unsharded grid
        unsharded = 2 * rows * lanes * 4
        for r, res in enumerate(ranks):
            c = res["collectives"]["clients"]
            if (res["store_bytes"] != split // 2 + whole
                    or set(c) != {"pod+data"}
                    or c["pod+data"]["bytes"] * 2 != rounds * unsharded
                    or c["pod+data"]["calls"] != 2 * rounds):
                raise AssertionError(
                    f"(bl): rank {r} store {res['store_bytes']} B (want "
                    f"{split // 2 + whole}), clients {c} (unsharded "
                    f"{unsharded} B a round)")
        t2 = time.time()
        last = twin["store_digests"][-1]
        store.load_tree(ckpt.restore(ckpt.step_dir(ck, 2), store.to_tree()))
        if store.block_digests(2) != last:
            raise AssertionError("(bl): the ranks' save restored into the "
                                 "twin's layout is not the twin's store")
        t_restore = time.time() - t2
        c0 = ranks[0]["collectives"]
        print(f"[12 shards (bl)] qwen2-0.5b at {SHARD_LAYERS} of 24 layers, "
              f"W = 2 over M = 4 clients, vrl_sgd + sgd, 2 rounds of k = 1 "
              f"on gloo (data 2 x shard 2): the ranks' losses "
              f"{['%.6f' % x for x in one.losses]} and launches "
              f"{BL_LAUNCHES} bitwise the twin's; after each round every "
              f"rank's row block of the store bitwise the twin's block; a "
              f"rank's store {ranks[0]['store_bytes']} B host (the twin "
              f"{store.nbytes} B: {split} of rows ÷ 2 + {whole} B of "
              f"globals); \"clients\" "
              f"{c0['clients']['pod+data']['bytes'] // rounds} B a round a "
              f"rank ({unsharded} on an unsharded grid), save gathered "
              f"{json.dumps(c0.get('checkpoint'))}; the step-2 save "
              f"restored into the twin's layout bitwise its store; rank "
              f"0's gather / scatter s a round "
              f"{json.dumps(ranks[0]['store_s'])}, the twin's "
              f"{json.dumps(twin['store_s'])}; the ranks {t_ranks:.1f} s from their launch, the twin "
              f"{t_twin:.1f} s, the restore and its check {t_restore:.1f} "
              f"s; {card}", flush=True)
        del one, store
        free()
    finally:
        stop_ranks(proc)
        shutil.rmtree(tmp, ignore_errors=True)


def start_chaos():
    """(av): ``python -m repro_torch.scripts.chaos_smoke --device cuda
    --world 1 --cpu-init`` (NCCL; from the CPU's draw of the init), a
    child started at the phase's start -> (process, log path,
    directory)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    log = os.path.join(tmp, "log.txt")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.scripts.chaos_smoke",
             "--device", "cuda", "--world", "1", "--cpu-init",
             "--metrics-dir", os.path.join(tmp, "metrics")], stdout=f,
            stderr=subprocess.STDOUT, cwd=ROOT, env=env,
            start_new_session=True)
    return proc, log, tmp


def av_result(chaos, card) -> None:
    """(av): the chaos check's exit, its losses and tolerance, and the
    three streams' events."""
    proc, log, _ = chaos
    try:
        rc = proc.wait(timeout=AU_TIMEOUT)
    except subprocess.TimeoutExpired:
        stop_ranks(proc)
        rc = "timeout"
    with open(log) as f:
        text = f.read()
    if rc != 0 or "chaos smoke OK" not in text:
        raise AssertionError(f"(av): the chaos check exited {rc}: "
                             f"{text[-4000:]}")
    line = next(x for x in text.splitlines()
                if x.startswith("clean avg_model_loss"))
    events = json.loads(next(x for x in text.splitlines()
                             if x.startswith("chaos events: "))[14:])
    kernels = re.findall(r"kernels: (\{[^}]*\})", text)
    print(f"[12 shards (av)] python -m repro_torch.scripts.chaos_smoke "
          f"--device cuda --world 1 --cpu-init (NCCL): {line}; events "
          f"{json.dumps(events)}; launches per run "
          f"{[{k: v for k, v in json.loads(s).items() if v} for s in kernels]}"
          f"; {card}", flush=True)


def shards_phase(dev, vu, card) -> None:
    """Phase 12: (as), (at) on the card in turn, (au)'s ranks and (av)
    beside them."""
    from repro_torch.launch import train as launch
    t12 = time.time() - START
    print(f"[12 shards] from {t12:.1f} s of the script; reckoned: (as) "
          f"~40 s (four gloo ranks, 2 steps through the host, then two "
          f"one-process runs), (at) ~50 s (two launches), (au)'s and "
          f"(bl)'s ranks and (av) beside them, (bl)'s twin ~20 s: ~120 s; "
          f"{card}", flush=True)
    free()
    chaos = start_chaos()
    au = au_start()
    bl = bl_start()
    try:
        as_path(vu, card, launch)
        at_path(vu, card, launch)
        au_path(card, au)
        bl_path(vu, card, launch, bl)
        av_result(chaos, card)
    finally:
        for proc, tmp in ((chaos[0], chaos[2]), (au[0], au[3]),
                          (bl[0], bl[3])):
            stop_ranks(proc)
            shutil.rmtree(tmp, ignore_errors=True)
    print(f"[12 shards] {time.time() - START - t12:.1f} s; the script "
          f"{time.time() - START:.1f} s", flush=True)


AX_LAYERS = 4                   # (ax): qwen2-0.5b at 4 of its 24 layers
AX_W, AX_BATCH, AX_SEQ, AX_K = 4, 8, 64, 2
ENGINE_GATE = 700_000_000       # the CI gate's per-device engine bytes


def aw_engine_mem(dev, card, dryrun, vu) -> None:
    """(aw): engine_mem for the ten archs and the CI gate's point, the
    card's memory against HBM_PER_CHIP, and the state the port trains at
    the sized point made on the card with the bytes engine_mem gives it,
    then one local step of the port's engine on it."""
    from repro_torch import tree as tm
    from repro_torch.configs import base, registry
    from repro_torch.core import engine as em
    from repro_torch.launch.mesh import HBM_PER_CHIP
    from repro_torch.models import transformer
    from repro_torch.models.param import abstract

    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[13 dry run (aw)] the card's memory {total} B "
          f"({total / 2**30:.2f} GiB) against HBM_PER_CHIP {HBM_PER_CHIP} "
          f"B; {card}", flush=True)
    if total < HBM_PER_CHIP:
        raise AssertionError(f"(aw): the card holds {total} B, less than "
                             f"launch.mesh.HBM_PER_CHIP = {HBM_PER_CHIP}")
    arts = {a: dryrun.engine_mem(a, verbose=False)
            for a in registry.list_archs()}
    print("[13 dry run (aw)] engine_mem, vrl_sgd + adam at the single "
          "mesh's W, GiB a device, the reference's layout, which the port "
          "trains (bf16 params), each with its fit in 80 GB: "
          + ", ".join(
              f"{a} {r['per_device_bytes'] / 2**30:.2f} ({r['fits_pod']})"
              for a, r in arts.items()),
          flush=True)
    gate = dryrun.engine_mem("qwen2-0.5b", shards=8,
                             moment_dtype="bfloat16", verbose=False)
    port_dev = gate["port"]["per_device_bytes"]
    if max(gate["per_device_bytes"], port_dev) > ENGINE_GATE:
        raise AssertionError(f"(aw): the CI gate's point holds "
                             f"{gate['per_device_bytes']} B a device in "
                             f"the reference's layout, {port_dev} B in the "
                             f"port's: over {ENGINE_GATE}")
    print(f"[13 dry run (aw)] the CI gate (qwen2-0.5b --shards 8 "
          f"--moment-dtype bfloat16), the reference's layout (bf16 params): "
          f"{gate['per_device_bytes']} B a device <= {ENGINE_GATE}, "
          f"{gate['reduction']}x below the fp32 baseline; the state the "
          f"port trains there: {port_dev} B a device, within that budget",
          flush=True)
    art = dryrun.engine_mem("qwen2-0.5b", workers=4, verbose=False)
    mesh_cfg = registry.mesh_roles("qwen2-0.5b")
    cfg = registry.padded_arch("qwen2-0.5b", mesh_cfg)
    vcfg = base.VRLConfig(inner_optimizer="adam", update_backend="fused")
    # the reference's layout, the one the port trains: bf16 parameters
    template = abstract(transformer.model_defs(cfg), torch.bfloat16)
    eng = em.make_engine(vcfg, template, device=dev)
    params = tm.tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                               device=dev), template)
    state = eng.init(params, 4)
    del params
    stores = {}
    for _, leaf in tm.state_leaves(state):
        if isinstance(leaf, torch.Tensor):
            st = leaf.untyped_storage()
            stores[st.data_ptr()] = st.nbytes()
    on_card = sum(stores.values())
    scalars = sorted(k for k, v in tm.state_leaves(state)
                     if not isinstance(v, torch.Tensor))
    want = art["port"]["total_bytes"]
    print(f"[13 dry run (aw)] padded qwen2-0.5b (16 heads, 24 layers), W = "
          f"4, adam: engine_mem sizes the port's state (bf16 params, fp32 "
          f"Δ and moments: the reference's layout) at {want} B, "
          f"{len(art['buffers'])} buffers "
          f"{json.dumps({k: b['shape'] for k, b in art['buffers'].items()})}"
          f"; the state made on the card holds {on_card} B in "
          f"{len(stores)} storages (the host's scalar leaves: {scalars})",
          flush=True)
    if on_card != want:
        raise AssertionError(f"(aw): the engine state on the card holds "
                             f"{on_card} B, engine_mem sizes {want}")
    # the port steps that state: one local step, zero bf16 gradients
    n0 = vu.LAUNCHES["fused_local_adam"]
    state = eng.local_step(state, torch.zeros_like(state.params))
    torch.cuda.synchronize(dev)
    if vu.LAUNCHES["fused_local_adam"] != n0 + 1 or state.step != 1:
        raise AssertionError("(aw): the local step on the sized state did "
                             "not launch fused_local_adam once")
    print(f"[13 dry run (aw)] one local step of the port's engine on it: "
          f"fused_local_adam launched once, the card's peak "
          f"{torch.cuda.max_memory_allocated(dev)} B", flush=True)
    del state, eng
    free()


AX_TIMED = 5                    # (ay): rounds timed after (ax)'s first


def clocks() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def profiled_round(bundle, state, tok, lab, dev):
    """One round under torch.profiler (CUPTI): the sum of its device
    events' own times (kernels, copies) and its spans (CUDA events, the
    profiler's cost on the host included).  Returns the state and
    {"busy_ms", "spans_ms"}, or {"error"} where the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    bundle.timer.events.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = bundle.round_step(state, tok, lab)
        torch.cuda.synchronize(dev)
    spans = bundle.timer.ms()
    busy = 0.0
    for ev in prof.key_averages():          # the device's own events
        if str(ev.device_type).endswith("CUDA"):
            t = getattr(ev, "self_device_time_total", None)
            busy += (t if t is not None else ev.self_cuda_time_total) / 1e3
    out = {"spans_ms": sum(sum(spans.get(n, [0.0]))
                           for n in ("fwd_bwd", "local", "sync")),
           "busy_ms": busy}
    if busy <= 0.0:
        out = {"error": "the profiler recorded no device time"}
    return state, {"profiled": out}


def ax_round(dev, vu, card, dryrun):
    """(ax): one round on the card under FlopCounterMode and the same round
    counted on meta tensors; then ``AX_TIMED`` rounds timed.  Returns the
    counted result, each timed round's span sums and the bytes of the
    state's params and Δ."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import base, registry
    from repro_torch.train.train_loop import make_train_step

    mesh_over = {"shape": (AX_W, 16)}       # W = 4 workers, tensor axis 16
    mesh_cfg = dataclasses.replace(registry.mesh_roles("qwen2-0.5b"),
                                   **mesh_over)
    cfg = dataclasses.replace(registry.padded_arch("qwen2-0.5b", mesh_cfg),
                              num_layers=AX_LAYERS)
    vcfg = base.VRLConfig(comm_period=AX_K, update_backend="fused",
                          learning_rate=1e-3)
    bundle = make_train_step(cfg, vcfg, device=dev, timed=True)
    state = bundle.init_state(0, AX_W)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    shape = (AX_K, AX_W, AX_BATCH, AX_SEQ)
    tok = torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev)
    lab = torch.randint(0, cfg.vocab_size, shape, generator=gen, device=dev)
    free()
    torch.cuda.reset_peak_memory_stats(dev)
    vu.reset_launches()
    with FlopCounterMode(display=False) as fm:
        state, losses = bundle.round_step(state, tok, lab)
        torch.cuda.synchronize(dev)
    launches = {k: v for k, v in vu.LAUNCHES.items() if v}
    card_flops = fm.get_total_flops()
    peak = torch.cuda.max_memory_allocated(dev)
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"(ax): losses not finite: {losses}")
    # the timed rounds: the first carries the cuBLAS set-up
    rounds = []
    for _ in range(AX_TIMED):
        bundle.timer.events.clear()
        state, _ = bundle.round_step(state, tok, lab)
        spans = bundle.timer.ms()
        rounds.append({n: sum(spans.get(n, [0.0]))
                       for n in ("fwd_bwd", "local", "sync")})
        rounds[-1]["clocks"] = clocks()
    # one more round under torch.profiler: the kernels' device time against
    # its spans, the share of the round the card computes
    state, busy = profiled_round(bundle, state, tok, lab, dev)
    rounds.append(busy)
    engine_bytes = sum(t.numel() * t.element_size()
                       for t in (state.params, state.delta))
    del state
    free()
    res = dryrun.lower_one(
        "qwen2-0.5b", "train_4k", multi_pod=False, fn_kind="round",
        round_k=AX_K, comm_period=AX_K, one_process=True,
        mesh_override=mesh_over, cfg_override={"num_layers": AX_LAYERS},
        shape_override=base.InputShape("ax", AX_SEQ, AX_W * AX_BATCH,
                                       "train"),
        allow_tf32=False, verbose=False,
        # the card's round runs fp32 parameters: the dry run at its dtype
        # (lower_one's default is the reference's bf16)
        param_dtype=torch.float32)
    meta = res.counted
    print(f"[13 dry run (ax)] qwen2-0.5b padded (16 heads), {AX_LAYERS} of "
          f"24 layers, W = {AX_W}, batch {AX_BATCH} x {AX_SEQ}, one round "
          f"of k = {AX_K}, vrl_sgd + sgd: the card's FlopCounterMode "
          f"{card_flops} FLOPs, the dry run's {meta.flops} "
          f"({meta.flops_by_dtype}); launches on the card {launches}, "
          f"charged on meta {meta.launches()}; max_memory_allocated "
          f"{peak} B, the meta peak {meta.peak_bytes} B (ratio "
          f"{peak / meta.peak_bytes:.4f}); counted in {meta.seconds:.1f} s "
          f"on the host; {card}", flush=True)
    if card_flops != meta.flops:
        raise AssertionError(f"(ax): the card counted {card_flops} FLOPs, "
                             f"the dry run {meta.flops}")
    if launches != meta.launches():
        raise AssertionError(f"(ax): launches {launches} on the card, "
                             f"{meta.launches()} charged by the dry run")
    return res, rounds, engine_bytes


def ay_roofline(res, rounds, engine_bytes, card) -> None:
    """(ay): (ax)'s roofline beside the timed rounds' spans (each round's
    value, then the median and the spread): the products' time against
    fwd_bwd, the engine pass (2 x the state's bytes over the HBM rate) and
    fused_local_sgd's bound against local, fused_sync_vrl's bound against
    sync, the round's bound against the round."""
    from repro_torch.launch import roofline as rl

    roof, k = res.roofline, res.counted.kernels
    t_products = 1e3 * (roof.t_compute
                        - roof.kernel_flops / PEAK_FLOPS_FP32)
    t_pass = 1e3 * rl.engine_pass_time(engine_bytes)
    t_local = bound_ms(k["fused_local_sgd"]["bytes"],
                       k["fused_local_sgd"]["flops"])[0]
    t_sync = bound_ms(k["fused_sync_vrl"]["bytes"],
                      k["fused_sync_vrl"]["flops"])[0]
    prof = rounds.pop()["profiled"]
    for r in rounds:
        r["round"] = r["fwd_bwd"] + r["local"] + r["sync"]
    print(f"[13 dry run (ay)] {len(rounds)} timed rounds of {AX_K} steps "
          f"after the first (CUDA events, ms; SM clock, max, power, "
          f"temperature after each): " + "; ".join(
              f"fwd_bwd {r['fwd_bwd']:.3f} local {r['local']:.3f} sync "
              f"{r['sync']:.3f} ({r['clocks']})" for r in rounds),
          flush=True)

    def med(key):
        vals = sorted(r[key] for r in rounds)
        return (float(np.median(vals)), vals[0], vals[-1])

    (fwd, f0, f1), (loc, l0, l1), (syn, s0, s1), (whole, w0, w1) = (
        med(n) for n in ("fwd_bwd", "local", "sync", "round"))
    bound = 1e3 * max(roof.t_compute, roof.t_memory)
    print(f"[13 dry run (ay)] roofline of (ax)'s round (the H100 data "
          f"sheet's fp32 {PEAK_FLOPS_FP32:.3g} FLOP/s, TF32 off, and "
          f"{HBM_BW:.4g} B/s): t_compute {1e3 * roof.t_compute:.3f} ms "
          f"(products {t_products:.3f}), t_memory "
          f"{1e3 * roof.t_memory:.3f} ms ({roof.hlo_bytes:.4g} B: "
          f"{res.counted.ops} ops and the kernels), t_engine_pass "
          f"{t_pass:.3f} ms a step; measured, the median of "
          f"{len(rounds)} rounds [min, max]: fwd_bwd {fwd:.3f} "
          f"[{f0:.3f}, {f1:.3f}] ms (the products' share "
          f"{100 * t_products / fwd:.1f}%), local {loc:.3f} [{l0:.3f}, "
          f"{l1:.3f}] ms (engine pass x {AX_K} "
          f"{100 * AX_K * t_pass / loc:.1f}%, fused_local_sgd's bound "
          f"{t_local:.3f} ms {100 * t_local / loc:.1f}%), sync {syn:.3f} "
          f"[{s0:.3f}, {s1:.3f}] ms (fused_sync_vrl's bound {t_sync:.3f} "
          f"ms, {100 * t_sync / syn:.1f}%), the round {whole:.3f} "
          f"[{w0:.3f}, {w1:.3f}] ms (bound {bound:.3f}, "
          f"{100 * bound / whole:.1f}%); {card}", flush=True)
    if "error" in prof:
        note = f"not measured ({prof['error']})"
    else:
        busy, spans = prof["busy_ms"], prof["spans_ms"]
        note = (f"the card's kernels and copies {busy:.3f} ms of its "
                f"{spans:.3f} ms of spans ({100 * busy / spans:.1f}% busy; "
                f"the rest the card waits on the host's launches, the "
                f"profiler's cost included); that device time is "
                f"{100 * busy / whole:.1f}% of the unprofiled rounds' "
                f"median {whole:.3f} ms")
    print(f"[13 dry run (ay)] one more round under torch.profiler: {note}",
          flush=True)


def dryrun_phase(dev, vu, card) -> None:
    """Phase 13: (aw)-(ay)."""
    from repro_torch.launch import dryrun
    t13 = time.time() - START
    print(f"[13 dry run] from {t13:.1f} s of the script; reckoned ~40 s; "
          f"{card}", flush=True)
    free()
    aw_engine_mem(dev, card, dryrun, vu)
    ay_roofline(*ax_round(dev, vu, card, dryrun), card)
    print(f"[13 dry run] {time.time() - START - t13:.1f} s; the script "
          f"{time.time() - START:.1f} s", flush=True)


# ------------------------------------------------ 14 bf16 parameters
# (az): each engine kernel's operands at the main path's shape, as phase 3
# holds them, the parameters, x̂ and the gradient in bf16 and Δ/B in fp32
# and in bf16 (where the kernel's path has them): name -> (positional
# operands, keyword operands, options); hierarchy's over HIER_FULL
AZ = {
    "fused_local_sgd": (("p", "g", "d"), (), dict(lr=LR, wd=1e-4)),
    "fused_local_momentum": (("p", "g", None, "m"), (),
                             dict(lr=LR, beta=0.9, wd=1e-4)),
    "fused_local_adam": (("p", "g", "d", "mu", "nu", "scal2"), ("b",),
                         dict(lr=1e-3, wd=1e-4)),
    "fused_local_adam_sm3": (("p", "g", "d", "mu", "row", "col", "scal2"),
                             (), dict(lr=1e-3, wd=1e-4)),
    "fused_sync_vrl": (("p", "xbar", "d", "scal1"), (), {}),
    "fused_sync_bvr": (("p", "xbar", "d", "b", "scal1"), (),
                       dict(beta=0.5)),
    "fused_sync_easgd": (("p", "xbar32", "center"), (),
                         dict(a=0.3 / FULL[0], na=0.3)),
    "fused_ef_int8": (("p", "ref", "e"), (), {}),
    "fused_ef_topk": (("p", "ref", "e"), (), dict(k=TOPK_FULL)),
    "fused_fold_overlap": (("p", "xbar", "pend", "d", "wscal"), (),
                           dict(capture=True)),
    "fused_fold_overlap_bvr": (("p", "xbar", "pend", "d", "b", "wscal"), (),
                               dict(beta=0.5, capture=False)),
    "fused_fold_overlap_avg": (("p", "xbar", "pend", "wscal"), (),
                               dict(capture=True)),
    "fused_hier_local_sgd": (("p", "g", "d1", "d2"), (),
                             dict(lr=LR, wd=1e-4)),
    "fused_sync_hier1": (("p", "xbar_pod", "d1", "scal1"), (), {}),
    "fused_sync_hier2": (("p", "glob", "d2", "scal1"), (), {}),
    "fused_fold_overlap_hier2": (("p", "glob", "pend2", "d2", "wscal"), (),
                                 dict(capture=True)),
    "fused_hier_local_momentum": (("p", "g", "d1", "d2", "m"), (),
                                  dict(lr=HIER_MOMENTUM_LR, beta=0.9,
                                       wd=1e-4)),
    "fused_hier_local_adam": (("p", "g", "d1", "d2", "mu", "nu", "scal2"),
                              (), dict(lr=1e-3, wd=1e-4)),
    "fused_hier_local_adam_sm3": (("p", "g", "d1", "d2", "mu16", "row",
                                   "col", "scal2"), (),
                                  dict(lr=1e-3, wd=1e-4)),
    "fused_ef_int8_grid": (("p", "ref_pod", "e"), (), {}),
    "fused_ef_topk_grid": (("p", "ref_pod", "e"), (), dict(k=TOPK_FULL)),
}
# the element-size options of each kernel's cost (kernels.costs) where
# they are not all of pb, gb, db: no gradient, no Δ
AZ_SIZES = {"fused_sync_vrl": ("pb", "db"), "fused_sync_bvr": ("pb", "db"),
            "fused_sync_easgd": ("pb",), "fused_ef_int8": ("pb",),
            "fused_ef_topk": ("pb",), "fused_fold_overlap": ("pb", "db"),
            "fused_fold_overlap_bvr": ("pb", "db"),
            "fused_fold_overlap_avg": ("pb", "db"),
            "fused_sync_hier1": ("pb", "db"), "fused_sync_hier2": ("pb", "db"),
            "fused_fold_overlap_hier2": ("pb", "db"),
            "fused_ef_int8_grid": ("pb",), "fused_ef_topk_grid": ("pb",)}
AZ_PARAMS = frozenset({"p", "g", "xbar", "xbar_pod", "glob"})
AZ_DRIFT = frozenset({"d", "b", "d1", "d2"})
BA_ROUNDS = [3, 3]              # (ba): two rounds of k = 3


def az_operands(name, ddt, dev, gen):
    """The operands of ``name`` at full width: (args, kwargs, shape)."""
    from repro_torch.optim import adam_scal
    hier = name in HIER_KERNELS
    shape = HIER_FULL if hier else FULL
    lead = shape[:-2]
    pod = (shape[0], 1) + shape[2:]
    rc = shape[-2:]
    pos, kws, opts = AZ[name]

    def randn(sh, scale=1.0):
        return torch.randn(sh, generator=gen, device=dev).mul_(scale)

    def make(key):
        if key is None:
            return None
        if key == "p":
            x = randn(shape)
            if name in ("fused_sync_hier2", "fused_fold_overlap_hier2"):
                x[:, 1:] = x[:, :1]     # after a level-1 sync
            return x
        if key in ("g",):
            return randn(shape)
        if key in ("d", "b", "d1", "m", "mu"):
            return randn(shape, 0.1)
        if key == "mu16":
            return randn(shape, 0.1).to(torch.bfloat16)
        if key == "d2":
            return randn(pod, 0.1)
        if key == "nu":
            return randn(shape).square_().mul_(0.01)
        if key == "row":
            return randn(lead + (rc[0], 1)).square_().mul_(0.01)
        if key == "col":
            return randn(lead + (1, rc[1])).square_().mul_(0.01)
        if key in ("xbar", "xbar32", "glob", "center", "ref"):
            return randn(rc)
        if key in ("xbar_pod", "ref_pod", "pend2"):
            return randn(pod)
        if key == "e":
            return randn(shape, 0.01)
        if key == "pend":
            return randn(shape)
        if key == "scal1":
            return kg_scal(2, dev)
        if key == "scal2":
            return adam_scal(3, dev)
        if key == "wscal":
            return wscal_for(shape[0], dev, (2,), (0,))
        raise KeyError(key)

    def cast(key, x):
        if key in AZ_PARAMS:
            return x.to(torch.bfloat16)
        if key in AZ_DRIFT:
            return x.to(ddt)
        return x
    args = [None if k is None else cast(k, make(k)) for k in pos]
    kw = {k: cast(k, make(k)) for k in kws}
    return args, dict(kw, **opts), shape


def az_kernels(chk, vu, tu, dev, times32) -> dict:
    """(az): each kernel at bf16 p, g and x̂ with an fp32 and (where its
    path has one) a bf16 Δ/B: bitwise its plain version slice by slice,
    timed in place (CUDA events) beside its byte bound at those operand
    sizes, the plain version timed slice by slice, and ``torch._fused_sgd_``
    on the bf16 parameters without Δ where it computes the same step.
    Returns {kernel: {...}} for the JSON line."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    out = {}
    for name in AZ:
        has_d = any(k in AZ_DRIFT for k in AZ[name][0] + AZ[name][1]
                    if k is not None)
        row = {}
        for ddt in ((torch.float32, torch.bfloat16) if has_d
                    else (torch.float32,)):
            args, kw, shape = az_operands(name, ddt, dev, gen)
            ndim = len(shape)
            per_worker = ndim == 4 and "local" in name
            slices = [worker_slice(i, args, kw, ndim, per_worker)
                      for i in range(slice_count(args, ndim, per_worker))]
            # bitwise slice by slice (no collection between slices: the
            # clones go with their references)
            for i, (sl_args, sl_kw) in enumerate(slices):
                chk.run(name, sl_args, f"bf16 full shape, slice {i}",
                        **sl_kw)
            ms = time_ms(lambda: getattr(vu, name)(*args, **kw), 5,
                         warmup=1)
            fn = getattr(tu, name)

            def run():
                for sl_args, sl_kw in slices:
                    fn(*sl_args, **sl_kw)
            # the plain version timed once, beside the fp32 Δ's kernel
            plain_ms = (time_ms(run, 1, warmup=0) if ddt == torch.float32
                        else None)
            del slices
            # the cost model's defaults are these paths' operands; the
            # element sizes are this call's
            sizes = {"pb": 2, "gb": 2, "db": 2 if ddt == torch.bfloat16
                     else 4}
            b, by = bound_ms(*COSTS[name](*shape, **{
                k: sizes[k] for k in AZ_SIZES.get(name, ("pb", "gb", "db"))
            }))
            lib = None
            if name in ("fused_local_sgd", "fused_hier_local_sgd"):
                # torch._fused_sgd_ on the bf16 parameters, momentum 0,
                # without Δ: its time over the worker slices
                ps = list(args[0].flatten(0, ndim - 3).unbind(0))
                gs = list(args[1].flatten(0, ndim - 3).unbind(0))
                lib = time_ms(lambda: torch._fused_sgd_(
                    ps, gs, [], weight_decay=1e-4, momentum=0.0, lr=LR,
                    dampening=0.0, nesterov=False, maximize=False,
                    is_first_step=False), 5, warmup=1)
                del ps, gs
            tag = "bf16" if ddt == torch.bfloat16 else "fp32"
            row[tag] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                        "bound_by": by, "library_ms": lib}
            fp32 = times32.get(name)
            label = f"{tag} Δ" if has_d else "no Δ"
            print(f"[14 bf16 (az)] {name} at {shape}, bf16 p/g/x̂, {label}: "
                  f"{ms:.3f} ms (fp32 operands, phase 3: "
                  f"{'not measured' if fp32 is None else f'{fp32:.3f} ms'});"
                  f" bound {b:.3f} ms ({by}, {100 * b / ms:.1f}%)"
                  + ("" if plain_ms is None else
                     f"; plain {plain_ms:.3f} ms (slice by slice)")
                  + ("" if lib is None else
                     f"; torch._fused_sgd_ without Δ {lib:.3f} ms")
                  + "; bitwise the plain version", flush=True)
            del args, kw
        free()
        out[name] = row
    return out


def ba_training(dev, vu, card, fp32_peak=None) -> dict:
    """(ba): qwen2-0.5b at full width (24 layers) trained through
    ``make_train_step(param_dtype=torch.bfloat16)``: vrl_sgd + sgd, then +
    adam, W = 4, batch 8 × 64, two rounds of k = 3 (fp32 Δ and moments).
    Gates: finite losses; after each sync Σ_i Δ_i within the bf16 rounding
    of x̂ (|Σ_i Δ_i| <= the sum over the syncs of W · ulp_bf16(x̂) / (k γ),
    elementwise, with an fp32 margin), where fp32 parameters keep it at
    fp32 rounding; the bytes of the state's storages on the card equal
    ``engine_mem``'s
    sizing of that state (``launch.dryrun._engine_state_bytes``); the
    launches.  The peak beside the fp32 run's (phase 4's vrl_sgd + sgd,
    the same model and batch).  Returns {path: result}."""
    from repro_torch import tree as tm
    from repro_torch.configs import registry
    from repro_torch.configs.base import VRLConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer

    cfg = registry.get_arch("qwen2-0.5b")

    def start(bundle, w):
        """torch's draw (seed 0) in bf16 with wq, wk × 0.1: at full depth
        the plain draw's attention is near one-hot and its first
        gradients reach ~1e12 (fp32 and bf16 alike; ~0.16 softened)."""
        params = transformer.init_params(cfg, 0, torch.bfloat16,
                                         device=dev)
        attn = params["layers"]["attn"]
        attn["wq"].mul_(0.1)
        attn["wk"].mul_(0.1)
        return bundle.engine.init(params, w)
    res = {}
    for inner, local in (("sgd", "fused_local_sgd"),
                         ("adam", "fused_local_adam")):
        vrl_kw = dict(algorithm="vrl_sgd", comm_period=BA_ROUNDS[0],
                      learning_rate=MAIN_LR, warmup=False,
                      inner_optimizer=inner, update_backend="fused")
        lim = []                # the bound, summed over the syncs so far

        def watch(state):
            def check(state, k):
                # this sync's x̂ rounding: at most half a bf16 ulp of x̂
                # an element, W of them over k γ (a whole ulp: margin)
                xhat = state.params[0].float()
                ulp = torch.abs(xhat).clamp_(min=2.0 ** -126)
                ulp = torch.exp2(torch.floor(torch.log2(ulp)) - 7)
                step = ulp.mul_(state.delta.shape[0] / (k * MAIN_LR))
                if lim:
                    lim[0].add_(step)
                else:
                    lim.append(step)
                s = state.delta.sum(dim=0)
                over = (s.abs() - lim[0]).max().item()
                scale = amax(state.delta)
                ok = over <= 1e-4 * scale
                rec = {"sum": amax(s), "limit_max": amax(lim[0]),
                       "over": over, "scale": scale}
                del xhat, s
                if not ok:
                    raise AssertionError(f"(ba) {inner}: Σ_i Δ_i beyond "
                                         f"the bf16 rounding of x̂: {rec}")
                return rec
            return check

        def after(bundle, state, vrl):
            stores = {}
            for _, leaf in tm.state_leaves(state):
                if isinstance(leaf, torch.Tensor):
                    st = leaf.untyped_storage()
                    stores[st.data_ptr()] = st.nbytes()
            on_card = sum(stores.values())
            sized = dryrun._engine_state_bytes(cfg, vrl, 4, torch.bfloat16)
            want = sum(b["bytes"] for b in sized.values())
            dtypes = {k: str(v.dtype).replace("torch.", "")
                      for k, v in tm.state_leaves(state)
                      if isinstance(v, torch.Tensor)}
            if on_card != want or dtypes["params"] != "bfloat16":
                raise AssertionError(f"(ba) {inner}: the state on the card "
                                     f"holds {on_card} B ({dtypes}), "
                                     f"engine_mem sizes {want}")
            return (f"; the state on the card {on_card} B = engine_mem's "
                    f"{want} ({json.dumps(dtypes)})")

        r = train_path(f"(ba) vrl_sgd+{inner}, bf16 params", vrl_kw,
                       BA_ROUNDS, {local: sum(BA_ROUNDS),
                                   "fused_sync_vrl": len(BA_ROUNDS)},
                       dev, vu, watch=watch, after=after, cfg=cfg,
                       make_kw={"param_dtype": torch.bfloat16},
                       start=start)
        lim.clear()
        res[inner] = r
        sums = "; ".join(f"sync {i + 1}: max|Σ Δ| {w['sum']:.3e} <= "
                         f"bound up to {w['limit_max']:.3e}"
                         for i, w in enumerate(r["watched"]))
        print_path(r, f"; {sums}{r['note']}; peak {r['peak_gib']:.2f} GiB "
                   f"(fp32 params, phase 4's vrl_sgd+sgd: "
                   + ("not measured" if fp32_peak is None
                      else f"{fp32_peak:.2f} GiB") + f"); {card}",
                   phase="14 bf16")
    return res


def bf16_phase(dev, vu, tu, card, chk, times32=None, fp32_peak=None):
    """Phase 14: (az), (ba); returns ({kernel: bf16 numbers}, {kernel:
    launches in (ba)})."""
    t14 = time.time() - START
    print(f"[14 bf16] from {t14:.1f} s of the script; {card}", flush=True)
    free()
    rows = az_kernels(chk, vu, tu, dev, times32 or {})
    ba = ba_training(dev, vu, card, fp32_peak)
    launches = {}
    for r in ba.values():
        for name, n in r["launches"].items():
            launches.setdefault(name, n)
    print(f"[14 bf16] {time.time() - START - t14:.1f} s; the script "
          f"{time.time() - START:.1f} s", flush=True)
    return rows, launches


# ------------------------------------------------ 15 a worker over ranks
# (bb): phi3.5-moe at full width (d 4096, 16 experts top-2, moe_d_ff 6400,
# vocab 32,064), 1 of 32 layers, one worker over 2 fsdp ranks on gloo (NCCL
# refuses two ranks on one card): bf16 parameters and Δ (the reference's
# layout for its FSDP archs), vrl_sgd + sgd, the worker's batch 8 x 64 (4 x
# 64 a rank), k = 2, remat on, the router's aux loss in the loss.  Each rank holds ~6 B a parameter (params, Δ, the gradient: 9.4 GB
# at 1.56e9) plus the gradient mean's fp32 wire copy (6.2 GB), rank 0 the
# one-process twin after its own run (another 9.4 GB): ~35 GB in all.
# one round: the gradient mean takes 7-18 s a step through gloo's host
# staging on an H100 host, and the phase keeps under 90 s
# one step and its sync (k = 1): each step's gradient mean moves 6.25 GB
# through gloo, 7-18 s (the script's time)
BB_FSDP, BB_BATCH, BB_SEQ, BB_K, BB_ROUNDS = 2, 8, 64, 1, 1
BB_RTOL = 1e-2                  # losses against the one-process twin
BB_SEED = 15
# (bc): two workers x fsdp 2 (gloo world 4) at the smoke MoE's widths,
# vrl_sgd + adam, fp32, a clip that binds, against one process with the
# two workers: the mesh standard (PERF.md §2)
BC_W, BC_FSDP, BC_RTOL, BC_CLIP, BC_LR = 2, 2, 1e-4, 0.5, 1e-3
FSDP_TIMEOUT = 600
# (bd): the reference's FSDP archs' training rows the dry run must lower
FSDP_ARCHS = ("chameleon-34b", "kimi-k2-1t-a32b", PHI)


def bb_config():
    """phi3.5-moe at full width, 1 of 32 layers."""
    from repro_torch.configs import registry
    return dataclasses.replace(registry.get_arch(PHI), num_layers=1)


def bb_vrl():
    from repro_torch.configs.base import VRLConfig
    return VRLConfig(comm_period=BB_K, warmup=False, learning_rate=MAIN_LR,
                     delta_dtype="bfloat16", update_backend="fused")


def bc_config():
    """The smoke phi3.5-moe at capacity factor 0.5 (its experts drop)."""
    from repro_torch.configs import registry
    return dataclasses.replace(registry.smoke_arch(PHI), capacity_factor=0.5)


def bc_vrl():
    from repro_torch.configs.base import VRLConfig
    return VRLConfig(comm_period=2, warmup=False, learning_rate=BC_LR,
                     inner_optimizer="adam", clip_norm=BC_CLIP,
                     update_backend="fused")


def fsdp_tokens(vocab, w, b, steps, seed, dev):
    """(steps, W, b, seq) ids from numpy and their next-token labels."""
    t = np.random.RandomState(seed).randint(
        0, vocab, (steps, w, b, BB_SEQ)).astype(np.int64)
    t = torch.from_numpy(t).to(dev)
    return t, torch.roll(t, -1, dims=-1)


def state_sums(state) -> list:
    """Two checksums of each of the state's tensors' bit patterns (their
    16- or 32-bit words summed, and weighted by position mod 65,521), on
    the card: equal states give equal sums."""
    out = []
    for t in (state.params, state.delta):
        words = t.view(torch.int16 if t.element_size() == 2
                       else torch.int32).reshape(-1)
        s1 = s2 = 0
        for chunk in words.split(1 << 26):
            c = chunk.to(torch.int64)
            s1 += int(c.sum())
            w = torch.arange(c.numel(), device=c.device) % 65521
            s2 += int((c * w).sum())
        out += [s1, s2]
    return out


def fsdp_rank_run(case: str, out: str) -> int:
    """Phase 15's ranks under ``torch.distributed.run`` (gloo, every rank
    on the one card): (bb) or (bc); a JSON per rank."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.comm import collectives as coll
    from repro_torch.kernels import vrl_update as vu
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import moe
    from repro_torch.train.train_loop import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    rec = {"rank": rank}
    if case == "bb":
        mesh = mesh_mod.make_engine_mesh(1, fsdp=BB_FSDP)
        cfg, vcfg, w, dtype = bb_config(), bb_vrl(), 1, torch.bfloat16
        tok, lab = fsdp_tokens(cfg.vocab_size, 1, BB_BATCH, BB_K * BB_ROUNDS,
                               BB_SEED, dev)
    else:
        mesh = mesh_mod.make_engine_mesh(BC_W, fsdp=BC_FSDP)
        cfg, vcfg, w, dtype = bc_config(), bc_vrl(), BC_W, torch.float32
        tok, lab = fsdp_tokens(cfg.vocab_size, BC_W, 4, 4, BB_SEED, dev)
    rec["coords"] = dict(zip(mesh.axes, mesh.coords))
    mine = mesh_mod.local_workers(mesh, w)

    def start(bundle):
        state = bundle.init_state(0, w)
        if case == "bc":
            from repro_torch.core import flat
            tree = flat.unflatten_stacked(bundle.engine.spec, state.params)
            for k in ("wq", "wk"):
                tree["layers"]["attn"][k].mul_(0.1)
        return state

    # the gradient mean's wall (host clock, synchronised), apart from the
    # rest of the step
    mean_ms = []
    orig = coll.fsdp_mean

    def timed_mean(m, buf, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        r = orig(m, buf, **kw)
        torch.cuda.synchronize(dev)
        mean_ms.append(1e3 * (time.perf_counter() - t0))
        return r
    coll.fsdp_mean = timed_mean
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    bundle = make_train_step(cfg, vcfg, device=dev, mesh=mesh,
                             param_dtype=dtype)
    state = start(bundle)
    torch.cuda.synchronize(dev)
    rec["init_s"] = time.perf_counter() - t0
    moe.TRACE = [] if case == "bb" else None
    losses, walls, sums, counted, total = [], [], [], {}, {}

    def launched():
        got = {k: v for k, v in vu.LAUNCHES.items() if v}
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return got
    for i in range(tok.shape[0]):
        vu.reset_launches()
        coll.reset_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) if i == 0 else \
                contextlib.nullcontext() as fm:
            state, loss = bundle.local_step(state, tok[i][mine], lab[i][mine])
            torch.cuda.synchronize(dev)
        walls.append(1e3 * (time.perf_counter() - t0))
        got = launched()
        if i == 0:
            counted["local"] = {
                "flops": fm.get_total_flops(), "launches": got,
                "counts": json.loads(json.dumps(coll.COUNTS))}
        losses.append(float(loss))
        if (i + 1) % (BB_K if case == "bb" else 2) == 0:
            vu.reset_launches()
            coll.reset_counts()
            first = "sync" not in counted
            with FlopCounterMode(display=False) if first else \
                    contextlib.nullcontext() as fm:
                state = bundle.sync_step(state)
                torch.cuda.synchronize(dev)
            got = launched()
            if first:
                counted["sync"] = {
                    "flops": fm.get_total_flops(), "launches": got,
                    "counts": json.loads(json.dumps(coll.COUNTS))}
        sums.append(state_sums(state))
    coll.fsdp_mean = orig
    trace = moe.TRACE
    moe.TRACE = None
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (rec["coords"], sums))
    rec.update(losses=losses, walls=walls, mean_ms=mean_ms, counted=counted,
               launches=total,
               peak=torch.cuda.max_memory_allocated(dev),
               state_bytes=sum(t.numel() * t.element_size()
                               for t in (state.params, state.delta)),
               wire_bytes=state.params.numel() * 4,
               finite=bool(torch.isfinite(torch.tensor(losses)).all()))
    # each fsdp rank's sums after every step equal its peers'
    rec["peers_bitwise"] = all(
        s == sums for c, s in every
        if {a: v for a, v in c.items() if a != "fsdp"}
        == {a: v for a, v in rec["coords"].items() if a != "fsdp"})
    full = mesh_mod.gather_state(mesh, state) if case == "bc" else None
    if case == "bb":
        torch.save(trace, f"{out}.trace{rank}")
    del bundle, state
    free()
    dist.barrier()
    if rank == 0:
        # the one-process twin: the same worker(s) on the whole batch
        moe.TRACE = [] if case == "bb" else None
        torch.cuda.reset_peak_memory_stats(dev)
        twin = make_train_step(cfg, vcfg, device=dev, param_dtype=dtype)
        st = start(twin)
        tl = []
        for i in range(tok.shape[0]):
            st, loss = twin.local_step(st, tok[i], lab[i])
            tl.append(float(loss))
            if (i + 1) % 2 == 0:
                st = twin.sync_step(st)
        rec["twin_losses"] = tl
        rec["twin_peak"] = torch.cuda.max_memory_allocated(dev)
        rec["loss_rel"] = max(abs(a - b) / abs(b)
                              for a, b in zip(losses, tl))
        if case == "bb":
            parts = [trace, torch.load(f"{out}.trace1")]
            whole = moe.TRACE
            moe.TRACE = None
            rec["dispatches"] = len(whole)
            if not len(whole) == len(parts[0]) == len(parts[1]):
                raise AssertionError(f"(bb): {len(whole)} dispatches in one "
                                     f"process, {len(parts[0])} and "
                                     f"{len(parts[1])} on the ranks")
            # per dispatch (each step's forward and its recompute): the
            # share of entries whose kept flag and slot are the one
            # process's
            rec["dispatch_equal"] = [
                float(((torch.cat([a[0], b[0]]) == c[0])
                       & (torch.cat([a[1], b[1]]) == c[1])).float().mean())
                for a, b, c in zip(parts[0], parts[1], whole)]
            rec["kept"] = [int(c[0].sum()) for c in whole[:1]]
            rec["entries"] = int(whole[0][0].numel())
        else:
            p = full.params.to(torch.float32).cpu().numpy()
            q = st.params.to(torch.float32).cpu().numpy()
            diff = np.abs(p - q)
            scale = max(1.0, float(np.abs(q).max()))
            rec["param_err"] = float(diff.max())
            rec["param_over"] = float((diff > BC_RTOL * scale).mean())
            # the clip binds: the first step's gradient norm before it
            noclip = make_train_step(cfg, dataclasses.replace(
                vcfg, clip_norm=0.0), device=dev)
            g, _ = noclip.grads_fn(start(noclip), tok[0], lab[0])
            rec["grad_norm"] = float(torch.linalg.vector_norm(g))
        del twin, st
    with open(f"{out}.rank{rank}", "w") as f:
        json.dump(rec, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def fsdp_dry_rows(out: str) -> int:
    """(bd)'s child process: the FSDP archs' local and sync rows on both
    meshes through ``lower_one``, one JSON line each."""
    from repro_torch.launch import dryrun
    with open(out, "w") as f:
        for arch in FSDP_ARCHS:
            for multi in (False, True):
                for fn in ("local", "sync"):
                    row = dryrun.lower_one(arch, "train_4k", multi_pod=multi,
                                           fn_kind=fn, verbose=False)
                    f.write(json.dumps(row.to_json()) + "\n")
    return 0


def launch_ranks(case: str, nproc: int, tmp: str):
    out, log = os.path.join(tmp, case), os.path.join(tmp, f"{case}.log")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(nproc), os.path.abspath(__file__),
             "--fsdp-ranks", case, out], stdout=f,
            stderr=subprocess.STDOUT, cwd=ROOT, env=env,
            start_new_session=True)
    return proc, out, log


def fsdp_phase(dev, vu, card) -> dict:
    """Phase 15: (bb) and (bc) launched side by side, (bd)'s rows in a
    child process beside them; returns (bb)'s launches."""
    from repro_torch.configs import base
    from repro_torch.launch import dryrun
    t15 = time.time() - START
    print(f"[15 fsdp] from {t15:.1f} s of the script; {card}", flush=True)
    free()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fsdp_")
    rows_out = os.path.join(tmp, "rows.jsonl")
    # at a lower priority: the ranks' gloo staging runs on the same cores
    dry = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--fsdp-dry", rows_out],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        start_new_session=True, preexec_fn=lambda: os.nice(10))
    runs = {"bb": launch_ranks("bb", BB_FSDP, tmp),
            "bc": launch_ranks("bc", BC_W * BC_FSDP, tmp)}
    try:
        ranks = {c: ranks_result(f"({c})", *runs[c], n, FSDP_TIMEOUT)
                 for c, n in (("bb", BB_FSDP), ("bc", BC_W * BC_FSDP))}
    finally:
        for proc, _, _ in runs.values():
            stop_ranks(proc)
    t_ranks = time.time() - START - t15
    # (bb)
    bb = ranks["bb"]
    r0 = bb[0]
    cfg = bb_config()
    from repro_torch.models import moe
    n_params = cfg.param_count()
    for r in bb:
        if not (r["finite"] and r["peers_bitwise"]):
            raise AssertionError(f"(bb): rank {r['rank']} losses "
                                 f"{r['losses']} or its state's sums differ "
                                 f"from its fsdp peer's")
        grad = r["counted"]["local"]["counts"].get("grad")
        # one mean a step of the rank's whole bf16 gradient, fp32 on the wire
        if grad != {"fsdp": {"calls": 1, "bytes": r["wire_bytes"],
                             "async": 0}}:
            raise AssertionError(f"(bb): rank {r['rank']} gradient "
                                 f"collectives {grad}")
    # the first step's dispatches (its forward and the remat recompute) run
    # on the same parameters as the one process's: bitwise; later steps'
    # parameters differ from the one process's by bf16 roundings of a
    # gradient summed in another order, which moves near-tied routings
    first = r0["dispatch_equal"][:2]
    if r0["loss_rel"] > BB_RTOL or first != [1.0, 1.0]:
        raise AssertionError(
            f"(bb): losses {r0['losses']} against the one process's "
            f"{r0['twin_losses']} (max rel {r0['loss_rel']:.3e}, limit "
            f"{BB_RTOL}), or the first step's kept entries and slots "
            f"differ (shares equal: {first})")
    steps = len(r0["walls"])
    print(f"[15 fsdp (bb)] {PHI} at full width (d {cfg.d_model}, "
          f"{cfg.num_experts} experts top-{cfg.experts_per_token}, moe_d_ff "
          f"{cfg.moe_d_ff}, vocab {cfg.vocab_size}), 1 of 32 layers, "
          f"{n_params} parameters, bf16 params and Δ, one worker over "
          f"{BB_FSDP} fsdp ranks on gloo, batch {BB_BATCH} x {BB_SEQ} "
          f"({BB_BATCH // BB_FSDP} x {BB_SEQ} a rank), k = {BB_K}, "
          f"{BB_ROUNDS} rounds, remat on: losses {r0['losses']} against the "
          f"one process's {r0['twin_losses']} (max rel "
          f"{r0['loss_rel']:.3e} <= {BB_RTOL}); the first step's "
          f"dispatches (forward and recompute) bitwise the one process's "
          f"kept mask and slots ({r0['kept'][0]} of {r0['entries']} "
          f"entries kept, capacity {moe.capacity(cfg, BB_BATCH * BB_SEQ)} "
          f"over the worker's {BB_BATCH * BB_SEQ} tokens); the share equal "
          f"in each of the {r0['dispatches']} dispatches "
          f"{', '.join('%.4f' % x for x in r0['dispatch_equal'])}; both "
          f"ranks' params and Δ bitwise after every step", flush=True)
    for r in bb:
        print(f"[15 fsdp (bb)] rank {r['rank']}: step wall ms "
              f"{', '.join('%.1f' % x for x in r['walls'])}; the gradient "
              f"mean's ms {', '.join('%.1f' % x for x in r['mean_ms'])} "
              f"({r['counted']['local']['counts']['grad']['fsdp']['bytes']}"
              f" B fp32 a step); init {r['init_s']:.1f} s; peak "
              f"{r['peak'] / 2**30:.2f} GiB (state {r['state_bytes'] / 1e9:.2f}"
              f" GB); collectives of step 1 "
              f"{json.dumps(r['counted']['local']['counts'])}; "
              f"launches in all {r['launches']}", flush=True)
    print(f"[15 fsdp (bb)] the twin's peak {r0['twin_peak'] / 2**30:.2f} "
          f"GiB; {steps} steps; {card}", flush=True)
    # (bc)
    c0 = ranks["bc"][0]
    for r in ranks["bc"]:
        if not (r["finite"] and r["peers_bitwise"]):
            raise AssertionError(f"(bc): rank {r['rank']} not finite or its "
                                 f"state differs from its fsdp peer's")
    if (c0["loss_rel"] > BC_RTOL or c0["param_over"] > 0.01
            or c0["param_err"] > 2 * BC_LR * len(c0["losses"])
            or c0["grad_norm"] <= BC_CLIP):
        raise AssertionError(
            f"(bc): losses {c0['losses']} vs {c0['twin_losses']} (rel "
            f"{c0['loss_rel']:.3e}), params max err {c0['param_err']:.3e}, "
            f"{c0['param_over']:.4f} of them past {BC_RTOL} · max|p|, the "
            f"first gradient's norm {c0['grad_norm']:.3f} (clip {BC_CLIP})")
    print(f"[15 fsdp (bc)] smoke {PHI} (capacity factor 0.5), {BC_W} "
          f"workers x fsdp {BC_FSDP} on gloo world {BC_W * BC_FSDP}, "
          f"vrl_sgd + adam, fp32, clip {BC_CLIP} (the first gradient's norm "
          f"{c0['grad_norm']:.3f}): losses within {c0['loss_rel']:.3e} "
          f"relative of one process with the two workers (limit "
          f"{BC_RTOL}); params max err {c0['param_err']:.3e} "
          f"({100 * c0['param_over']:.3f} % past {BC_RTOL} · max|p|; "
          f"Adam's ±γ steps); fsdp peers bitwise after every step; "
          f"{card}", flush=True)
    # (bd): (bb)'s local step and sync counted on a (1 x fsdp 2) dry mesh
    mesh_over = dict(shape=(BB_FSDP,), axis_names=("data",),
                     worker_axes=(), fsdp_axes=("data",), tensor_axes=())
    shape = base.InputShape("bb", BB_SEQ, BB_BATCH, "train")
    over = {"num_layers": 1, "vocab_size": cfg.vocab_size}
    for fn in ("local", "sync"):
        res = dryrun.lower_one(PHI, "train_4k", multi_pod=False, fn_kind=fn,
                               comm_period=BB_K, mesh_override=mesh_over,
                               cfg_override=over, shape_override=shape,
                               allow_tf32=False, verbose=False)
        meta, card_c = res.counted, r0["counted"][fn]
        if (meta.flops != card_c["flops"]
                or meta.launches() != card_c["launches"]
                or meta.counts != card_c["counts"]):
            raise AssertionError(
                f"(bd) {fn}: the dry run's {meta.flops} FLOPs, "
                f"{meta.launches()}, {meta.counts} against the card's "
                f"{card_c}")
        print(f"[15 fsdp (bd)] (bb)'s {fn} on a (1 x fsdp 2) dry mesh: "
              f"{meta.flops} FLOPs, launches {meta.launches()}, collectives "
              f"{json.dumps(meta.counts)}: equal to rank 0's on the card",
              flush=True)
    try:
        _, err = dry.communicate(timeout=FSDP_TIMEOUT)
    except subprocess.TimeoutExpired:
        stop_ranks(dry)
        raise AssertionError("(bd): the dry run's rows timed out")
    if dry.returncode != 0:
        raise AssertionError(f"(bd): the dry run's rows exited "
                             f"{dry.returncode}: {err.decode()[-2000:]}")
    rows = [json.loads(x) for x in open(rows_out)]
    bad = [(r["arch"], r["mesh"], r["fn"]) for r in rows if not r["ok"]]
    if bad or len(rows) != 4 * len(FSDP_ARCHS):
        raise AssertionError(f"(bd): rows not ok: {bad}")
    print(f"[15 fsdp (bd)] {', '.join(FSDP_ARCHS)}: train_4k local and sync "
          f"on the single and multi meshes, {len(rows)} rows ok (local "
          f"FLOPs a device: "
          f"{', '.join('%s/%s %.4g' % (r['arch'], r['mesh'], r['hlo_flops']) for r in rows if r['fn'] == 'local')})",
          flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"[15 fsdp] {time.time() - START - t15:.1f} s (the ranks "
          f"{t_ranks:.1f}); the script {time.time() - START:.1f} s",
          flush=True)
    return r0["launches"]


# ---------------------------------------------------------------- phase 16
# Tensor-parallel serving on a (data, model) rank grid: gloo ranks on the
# one card (NCCL refuses two ranks on one device), each case against its
# one-process twin on the same padded model, the twin first and alone.
# 8 generated tokens (cut from 32, the script's time): a decode step on
# gloo ranks sharing the one card takes 0.1-1.2 s, each collective waiting
# for the card's time slices between the ranks' contexts
TP_BATCH, TP_PROMPT, TP_GEN = 4, 32, 8
TP_SEED = 16
TP_RTOL = 1e-4                  # fp32 logits, × max|twin logits| (§2 mesh)
TP_PHI_LAYERS = 2               # of 32: the four cases' ranks share 80 GB
TP_HYMBA_LAYERS = 8             # of 32: the script's time
# case: (arch, layers (None: all; "smoke": the smoke model), (data,
# model), dtype name)
TP_CASES = {"be": ("qwen2-0.5b", None, (1, 4), "float32"),
            "bf": ("granite-3-2b", None, (1, 2), "float32"),
            "bg": (PHI, TP_PHI_LAYERS, (2, 2), "float32"),
            "bh": (KIMI, "smoke", (2, 2), "bfloat16"),
            "bj": (MAMBA, None, (1, 4), "float32"),
            "bk": (HYMBA, TP_HYMBA_LAYERS, (1, 2), "float32")}
TP_TIMEOUT = 400
# the launches, all at once (each spends ~30 s importing torch beside the
# others, more than its collectives lose to the contexts' time slices);
# the cases of one grid share its ranks, in turn
TP_LAUNCHES = (("be", "bj"), ("bf", "bk"), ("bg", "bh"))


def tp_case(case: str):
    """(padded config, serving ``MeshConfig``, dtype) of a phase-16 case:
    the arch's serving roles on the case's grid, the model padded for its
    tensor ranks."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import pad_for_mesh
    arch, layers, grid, dt = TP_CASES[case]
    roles = dataclasses.replace(registry.mesh_roles(arch, serving=True),
                                shape=grid)
    base = (registry.smoke_arch(arch) if layers == "smoke"
            else registry.get_arch(arch))
    if isinstance(layers, int):
        base = dataclasses.replace(base, num_layers=layers)
    return pad_for_mesh(base, grid[1]), roles, getattr(torch, dt)


def tp_prompt(cfg, dev) -> torch.Tensor:
    """The (TP_BATCH, TP_PROMPT) prompt, token ids from numpy."""
    t = np.random.RandomState(TP_SEED + 1).randint(
        0, cfg.vocab_size, (TP_BATCH, TP_PROMPT)).astype(np.int64)
    return torch.from_numpy(t).to(dev)


def tp_soften(params) -> None:
    """wq and wk × 0.1 in place (whole leaves or a rank's blocks alike;
    the hybrid's attention branch; the ssm family has none)."""
    layers = params["layers"]
    attn = layers["hyb"]["attn"] if "hyb" in layers else layers.get("attn")
    if attn is not None:
        attn["wq"].mul_(0.1)
        attn["wk"].mul_(0.1)


def tp_blocks(cfg, smesh, dtype, dev) -> dict:
    """This rank's blocks of ``transformer.init_params(cfg, TP_SEED,
    dtype, dev)``: the same leaves drawn in the same order from one
    generator (``models.param.materialize``'s values), each whole leaf cut
    by ``sharding.specs.rank_params`` and freed before the next is
    drawn."""
    from repro_torch import tree as tree_mod
    from repro_torch.models import transformer
    from repro_torch.models.param import _init_one
    from repro_torch.sharding import specs as sh
    gen = torch.Generator(device=dev)
    gen.manual_seed(TP_SEED)
    out = []
    for (path, d), (_, spec) in zip(
            tree_mod.leaves_with_path(transformer.model_defs(cfg)),
            tree_mod.leaves_with_path(smesh.specs(cfg))):
        whole = _init_one(d, gen, dtype, dev)
        out.append((path, sh.rank_params({"w": whole}, {"w": spec},
                                         smesh.mesh)["w"]))
        del whole
    return tree_mod.from_paths(out)


def tp_engine(cfg, params, dev, smesh=None, flops=False):
    """A ``serve.Engine`` that keeps each call's logits (on the card) and
    the collectives of its prefill and first decode step; with ``flops``
    also their FLOPs (``FlopCounterMode`` around those two calls: its
    Python dispatch adds ms to calls that gloo makes seconds long)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import tree as tree_mod
    from repro_torch.comm import collectives as coll
    from repro_torch.serve.engine import Engine

    class Recording(Engine):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.counts, self.flops, self.logits = {}, {}, []

        def _call(self, fn, key, *args):
            if key in self.counts:
                return fn(*args)
            coll.reset_counts()
            with (FlopCounterMode(display=False) if flops
                  else contextlib.nullcontext()) as fm:
                out = fn(*args)
            self.counts[key] = json.loads(json.dumps(coll.COUNTS))
            if flops:
                self.flops[key] = fm.get_total_flops()
            return out

        def prefill(self, prompt):
            out = self._call(super().prefill, "prefill", prompt)
            self.logits = [out[0]]
            self.cache_bytes = sum(t.numel() * t.element_size()
                                   for t in tree_mod.leaves(out[1]))
            return out

        def step(self, cache, tokens, pos, batch=None):
            out = self._call(super().step, "decode", cache, tokens, pos,
                             batch)
            self.logits.append(out[0])
            return out
    return Recording(cfg, params, max_len=TP_PROMPT + TP_GEN, device=dev,
                     mesh=smesh)


def tp_twin(case: str, path: str, dev) -> dict:
    """The case's one-process twin on the whole padded model: greedy
    tokens, each call's logits and times, saved to ``path``."""
    from repro_torch.models import transformer
    cfg, _, dtype = tp_case(case)
    free()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    params = transformer.init_params(cfg, TP_SEED, dtype, dev)
    tp_soften(params)
    torch.cuda.synchronize(dev)
    weights = torch.cuda.memory_allocated(dev)
    eng = tp_engine(cfg, params, dev)
    timings = {}
    tokens = eng.generate(tp_prompt(cfg, dev), TP_GEN, timings=timings)
    rec = {"tokens": tokens.cpu(),
           "logits": [x.float().cpu() for x in eng.logits],
           "prefill_ms": timings["prefill_ms"],
           "decode_ms": timings["decode_ms"], "weights": weights,
           "peak": torch.cuda.max_memory_allocated(dev)}
    torch.save(rec, path)
    del params, eng
    free()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def tp_design_count(case: str, fn: str) -> dict:
    """The design count of one prefill or decode step of a case, {kind:
    calls} (``tests/test_torch_tp_serve.py``'s ``design_count``): per
    layer a "tensor" sum after ``wo`` where the heads split and one after
    the MLP or the routed experts, in decode with the cache split by slots
    the query's gather (heads split), the max and the sum; an SSM block
    whose inner channels split three (the x channels' gather, the gated
    norm's sum, the sum after ``out_proj``); one sum for the embedding
    and one gather of the logits; "moe" one count gather a routed layer
    where the batch splits; "weights" one gather a weight a use on the
    FSDP ranks (13 a MoE layer with a shared expert, and the final norm,
    lm_head and embedding)."""
    cfg, roles, _ = tp_case(case)
    t, layers = roles.tensor_size, cfg.num_layers
    attn = cfg.family != "ssm"
    heads = attn and cfg.num_heads % t == 0
    per = int(heads) + int(attn)
    if fn == "decode" and attn and cfg.num_kv_heads % t:
        per += 2 + int(heads)
    if cfg.family in ("ssm", "hybrid") and cfg.ssm_d_inner % t == 0:
        per += 3
    counts = {"tensor": layers * per + 2}
    if cfg.family == "moe" and roles.num_workers * roles.fsdp_size > 1:
        counts["moe"] = layers
    if roles.fsdp_size > 1:
        counts["weights"] = layers * (2 + 4 + 4 + 3 * bool(
            cfg.num_shared_experts)) + 3
    return counts


def tp_compare(case: str, tokens, logits, twin, rows) -> dict:
    """A rank's greedy tokens and each call's logits against its twin's
    rows: tokens equal, or the first parting step a near-tie of the twin's
    top-2 logits; the logits of every step before it within the case's
    tolerance."""
    _, _, dtype = tp_case(case)
    want_tok = twin["tokens"][rows]
    part = (tokens != want_tok).any(dim=0).nonzero()
    stop = (int(part[0]) - TP_PROMPT) if len(part) else len(logits)
    worst, tie = 0.0, None
    for i in range(stop):
        got, want = logits[i].float().cpu(), twin["logits"][i][rows]
        if dtype == torch.bfloat16:
            row = want.abs().amax(dim=-1, keepdim=True)
            worst = max(worst, float(((got - want).abs() / row).max()))
        else:
            worst = max(worst, float((got - want).abs().max()
                                     / want.abs().max()))
    limit = 2.0 ** -5 if dtype == torch.bfloat16 else TP_RTOL
    if worst > limit:
        raise AssertionError(f"({case}): logits {worst:.3e} of the twin's "
                             f"scale apart (limit {limit})")
    if stop < len(logits):
        parted = (tokens[:, TP_PROMPT + stop] != want_tok[:, TP_PROMPT + stop])
        lg = twin["logits"][stop][rows][parted][:, -1]
        top2 = lg.topk(2, dim=-1).values
        gap = float((top2[:, 0] - top2[:, 1]).min())
        if gap > limit * float(lg.abs().max()):
            raise AssertionError(f"({case}): greedy tokens part from the "
                                 f"twin's at generated token {stop}, not a "
                                 f"near-tie (top-2 gap {gap:.3e})")
        tie = {"step": stop, "gap": gap}
    return {"err": worst, "tie": tie}


def tp_rank_run(cases: str, out: str) -> int:
    """Phase 16's ranks under ``torch.distributed.run`` (gloo, every rank
    on the one card): the cases of ``cases`` ("+"-joined, one grid) in
    turn; a JSON per case and rank."""
    import threading
    import torch.distributed as dist
    warm = None
    if "be" in cases.split("+"):
        # the flop counter's first use imports for seconds (longer while
        # the other launches import torch): beside the waits below, not
        # inside (be)'s timed prefill
        warm = threading.Thread(target=tp_warm_flops)
        warm.start()
    # the twins run alone on the card first: wait for them
    while not os.path.exists(os.path.join(out, "twins.done")):
        time.sleep(0.1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    start = time.time() - START
    dist.init_process_group("gloo")
    if warm is not None:
        warm.join()
    for case in cases.split("+"):
        rec = tp_rank_case(case, dev, out)
        rec["stamps"] = {"imported": 0.0, "start": start, **rec["stamps"]}
        with open(os.path.join(out, f"{case}.rank{rec['rank']}"), "w") as f:
            json.dump(rec, f)
        free()
    dist.barrier()
    dist.destroy_process_group()
    return 0


def tp_warm_flops() -> None:
    """One product under the flop counter: its first use's set-up."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False):
        torch.ones(2, 2) @ torch.ones(2, 2)


def tp_rank_case(case: str, dev, out: str) -> dict:
    """One phase-16 case on this rank: its blocks drawn in turn, the
    greedy generation timed, each step's logits against the twin's."""
    import torch.distributed as dist
    from repro_torch import tree as tree_mod
    from repro_torch.kernels import vrl_update as vu
    from repro_torch.launch import mesh as mesh_mod
    rank, world = dist.get_rank(), dist.get_world_size()
    cfg, roles, dtype = tp_case(case)
    smesh = mesh_mod.make_serve_mesh(roles)
    stamps = {"mesh": time.time() - START}
    rec = {"rank": rank, "stamps": stamps, "epoch": START,
           "coords": dict(zip(smesh.mesh.axes, smesh.mesh.coords))}
    t0 = time.perf_counter()
    # what the card holds already (an earlier case's cuBLAS workspace)
    held = torch.cuda.memory_allocated(dev)
    for r in range(world):
        # in turn: one whole leaf on the card at a time
        if r == rank:
            blocks = tp_blocks(cfg, smesh, dtype, dev)
            tp_soften(blocks)
            torch.cuda.synchronize(dev)
        dist.barrier()
    rec["load_s"] = time.perf_counter() - t0
    stamps["loaded"] = time.time() - START
    rec["weights"] = torch.cuda.memory_allocated(dev) - held
    rec["spec_bytes"] = sum(t.numel() * t.element_size()
                            for t in tree_mod.leaves(blocks))
    rec["leaves"] = len(tree_mod.leaves(blocks))
    torch.cuda.reset_peak_memory_stats(dev)
    prompt = tp_prompt(cfg, dev)
    # (bi): (be)'s prefill and first decode step under the flop counter
    eng = tp_engine(cfg, blocks, dev, smesh, flops=case == "be")
    rows = eng.rows(TP_BATCH)
    vu.reset_launches()
    timings = {}
    t0 = time.perf_counter()
    tokens = eng.generate(prompt, TP_GEN, timings=timings)
    rec["generate_s"] = time.perf_counter() - t0
    rec["launches"] = {k: v for k, v in vu.LAUNCHES.items() if v}
    rec.update(prefill_ms=timings["prefill_ms"],
               decode_ms=timings["decode_ms"], counts=eng.counts,
               flops=eng.flops, peak=torch.cuda.max_memory_allocated(dev),
               rows=[rows.start, rows.stop], cache_bytes=eng.cache_bytes,
               cache_spec_bytes=tp_cache_spec_bytes(cfg, roles, dtype))
    stamps["generated"] = time.time() - START
    twin = torch.load(os.path.join(out, f"twin_{case}.pt"))
    rec.update(tp_compare(case, tokens.cpu(), eng.logits, twin, rows))
    stamps["compared"] = time.time() - START
    return rec


def tp_cache_spec_bytes(cfg, roles, dtype) -> int:
    """A rank's bytes of the prefill cache by the specs: the whole
    batch's cache (``init_cache`` on meta tensors; the window's slots, or
    the prompt and generated tokens') cut by ``cache_specs``."""
    from repro_torch import tree as tree_mod
    from repro_torch.models import transformer
    from repro_torch.sharding import specs as sh
    w = cfg.attn_window
    slots = w if w else TP_PROMPT + TP_GEN
    whole = transformer.init_cache(cfg, TP_BATCH, slots, dtype=dtype,
                                   window=w, device="meta")
    sizes = dict(zip(roles.axis_names, roles.shape))
    return sum(math.prod(sh.block_shape(t.shape, spec, sizes))
               * t.element_size() for t, spec in zip(
                   tree_mod.leaves(whole),
                   tree_mod.leaves(sh.cache_specs(cfg, roles, TP_BATCH,
                                                  slots))))


def tp_dry_rows(out: str) -> int:
    """(bi)'s child process: kimi-k2's serving rows on both meshes through
    ``lower_one``, one JSON line each."""
    from repro_torch.launch import dryrun
    with open(out, "w") as f:
        for multi in (False, True):
            for shape in ("prefill_32k", "decode_32k", "long_500k"):
                row = dryrun.lower_one(KIMI, shape, multi_pod=multi,
                                       verbose=False)
                f.write(json.dumps(row.to_json()) + "\n")
    return 0


def tp_launch(cases: tuple, tmp: str):
    """Start the ranks of ``cases`` (one grid) under the launcher ->
    (process, log)."""
    nproc = math.prod(TP_CASES[cases[0]][2])
    log = os.path.join(tmp, f"{'+'.join(cases)}.log")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(nproc), os.path.abspath(__file__),
             "--tp-ranks", "+".join(cases), tmp], stdout=f,
            stderr=subprocess.STDOUT, cwd=ROOT, env=env,
            start_new_session=True)
    return proc, log


def tp_phase(dev, card) -> None:
    """Phase 16: each case's twin alone on the card, then the four cases'
    ranks side by side, (bi)'s kimi-k2 rows in a child process beside
    them, then (bi)'s dry (1 × 4) grid against (be)'s rank 0."""
    t16 = time.time() - START
    print(f"[16 tp] from {t16:.1f} s of the script; {card}", flush=True)
    free()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    procs = []
    try:
        rows_out = os.path.join(tmp, "rows.jsonl")
        dry = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tp-dry",
             rows_out], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            cwd=ROOT, env=dict(os.environ,
                               PYTHONPATH=os.path.join(ROOT, "src")),
            start_new_session=True, preexec_fn=lambda: os.nice(10))
        procs.append(dry)
        # the ranks start (import torch) while the twins run alone on the
        # card; they touch it once "twins.done" is written
        t_launch = time.time()
        runs = {cases: tp_launch(cases, tmp) for cases in TP_LAUNCHES}
        procs += [p for p, _ in runs.values()]
        twins = {}
        for case in TP_CASES:
            twins[case] = tp_twin(case, os.path.join(tmp, f"twin_{case}.pt"),
                                  dev)
        open(os.path.join(tmp, "twins.done"), "w").close()
        t_twins = time.time() - START - t16
        print(f"[16 tp] the twins {t_twins:.1f} s", flush=True)
        ranks = {}
        for cases, (proc, log) in runs.items():
            try:
                rc = proc.wait(timeout=TP_TIMEOUT)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                raise AssertionError(f"({'+'.join(cases)}): the ranks "
                                     f"exited {rc}: "
                                     f"{open(log).read()[-4000:]}")
            for case in cases:
                n = math.prod(TP_CASES[case][2])
                ranks[case] = [json.load(open(os.path.join(
                    tmp, f"{case}.rank{r}"))) for r in range(n)]
                r0 = ranks[case][0]
                # rank 0's stamps: s from its launch to each point
                st = {k: round(v + r0["epoch"] - t_launch, 1)
                      for k, v in r0["stamps"].items()}
                print(f"[16 tp ({case})] the ranks done at "
                      f"{time.time() - START - t16:.1f} s of the phase; rank "
                      f"0's s from the launch: {json.dumps(st)}; generate "
                      f"{r0['generate_s']:.1f} s", flush=True)
        t_ranks = time.time() - START - t16 - t_twins
        for case, recs in ranks.items():
            tp_report(case, recs, twins[case], card)
        tp_dry_check(ranks["be"][0])
        try:
            _, err = dry.communicate(timeout=TP_TIMEOUT)
        except subprocess.TimeoutExpired:
            raise AssertionError("(bi): kimi-k2's rows timed out")
        if dry.returncode != 0:
            raise AssertionError(f"(bi): kimi-k2's rows exited "
                                 f"{dry.returncode}: {err.decode()[-2000:]}")
        rows = [json.loads(x) for x in open(rows_out)]
        bad = [(r["shape"], r["mesh"]) for r in rows
               if not r["ok"] or r["chips"] != (256 if r["mesh"] == "single"
                                                else 512)]
        if bad or len(rows) != 6:
            raise AssertionError(f"(bi): kimi-k2's rows not ok: {bad}")
        print(f"[16 tp (bi)] {KIMI} serving on its 2D layout: "
              + "; ".join(f"{r['shape']}/{r['mesh']} ok on {r['chips']} "
                          f"chips, {r['per_device_bytes'] / 2**30:.2f} GiB "
                          f"a device, {r['bottleneck']}-bound "
                          f"(collective {r['t_collective'] * 1e3:.1f} ms)"
                          for r in rows), flush=True)
    finally:
        for p in procs:
            stop_ranks(p)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[16 tp] {time.time() - START - t16:.1f} s (the twins "
          f"{t_twins:.1f}, the ranks {t_ranks:.1f}); the script "
          f"{time.time() - START:.1f} s", flush=True)


def tp_dry_check(r0: dict) -> None:
    """(bi): (be)'s prefill and first decode step on the dry (1 × 4)
    serving grid against its rank 0 on the card."""
    from repro_torch.configs import base
    from repro_torch.launch import dryrun
    cfg, roles, dtype = tp_case("be")
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for fn, seq in (("prefill", TP_PROMPT), ("decode", TP_PROMPT + TP_GEN)):
        res = dryrun.lower_one(
            TP_CASES["be"][0], "decode_32k", multi_pod=False, fn_kind=fn,
            mesh_override={"shape": roles.shape}, cfg_override=over,
            last_only=True, param_dtype=dtype,
            shape_override=base.InputShape("be", seq, TP_BATCH, fn),
            allow_tf32=False, verbose=False)
        meta = res.counted
        if (meta.flops != r0["flops"][fn] or meta.launches()
                or r0["launches"] or meta.counts != r0["counts"][fn]):
            raise AssertionError(
                f"(bi) {fn}: the dry grid's {meta.flops} FLOPs, "
                f"{meta.launches()}, {meta.counts} against rank 0's "
                f"{r0['flops'][fn]}, {r0['launches']}, "
                f"{r0['counts'][fn]}")
        print(f"[16 tp (bi)] (be)'s {fn} on a dry {roles.shape} serving "
              f"grid: {meta.flops} FLOPs, no launch, collectives "
              f"{json.dumps(meta.counts)}: equal to rank 0's on the card; "
              f"chips {res.roofline.chips}", flush=True)


def tp_report(case: str, recs: list, twin: dict, card: str) -> None:
    """Check and print one case's ranks."""
    cfg, roles, dtype = tp_case(case)
    want = {fn: tp_design_count(case, fn) for fn in ("prefill", "decode")}
    for r in recs:
        got = {fn: {k: sum(v["calls"] for v in d.values())
                    for k, d in r["counts"][fn].items()}
               for fn in ("prefill", "decode")}
        # the allocator's rounding: a block of 512-byte units, a large
        # one keeping its segment's unsplit remainder (< 1 MiB)
        slack = r["leaves"] << 20
        if (got != want or r["launches"]
                or not 0 <= r["weights"] - r["spec_bytes"] <= slack
                or r["cache_bytes"] != r["cache_spec_bytes"]):
            raise AssertionError(
                f"({case}) rank {r['rank']}: collectives {got} (design "
                f"{want}), launches {r['launches']}, weight bytes "
                f"{r['weights']} against the spec count {r['spec_bytes']}, "
                f"cache bytes {r['cache_bytes']} against "
                f"{r['cache_spec_bytes']}")
    arch, layers, grid, dt = TP_CASES[case]
    depth = (f"{cfg.num_layers} layers" if layers is None else
             "the smoke model" if layers == "smoke" else
             f"{layers} of 32 layers")
    tw = np.array(twin["decode_ms"])
    ties = [r["tie"] for r in recs if r["tie"]]
    ssm = (f", SSM heads {cfg.ssm_num_heads} over d_inner "
           f"{cfg.ssm_d_inner}" if cfg.ssm_state else "")
    print(f"[16 tp ({case})] {arch}, {depth}, {dt}, over data {grid[0]} x "
          f"model {grid[1]} (heads {cfg.num_heads}, kv {cfg.num_kv_heads}"
          f"{ssm}, vocab {cfg.vocab_size}), batch {TP_BATCH} x {TP_PROMPT} + "
          f"{TP_GEN}: every rank's greedy tokens "
          f"{'equal to the twin' + chr(39) + 's' if not ties else 'part at a near-tie ' + json.dumps(ties)}; "
          f"logits within {max(r['err'] for r in recs):.3e} of the twin's "
          f"scale; no kernel launched; collectives a prefill "
          f"{json.dumps(want['prefill'])}, a decode step "
          f"{json.dumps(want['decode'])} (the design count); the twin "
          f"prefill {twin['prefill_ms']:.1f} ms, decode median "
          f"{np.median(tw):.2f} ms a token ({tw.min():.2f}-{tw.max():.2f}), "
          f"weights {twin['weights']} B, peak "
          f"{twin['peak'] / 2**30:.2f} GiB, {twin['seconds']:.1f} s in all; "
          f"{card}", flush=True)
    for r in recs:
        d = np.array(r["decode_ms"])
        print(f"[16 tp ({case})] rank {r['rank']} {json.dumps(r['coords'])} "
              f"rows {r['rows']}: prefill {r['prefill_ms']:.1f} ms, decode "
              f"median {np.median(d):.2f} ms a token "
              f"({d.min():.2f}-{d.max():.2f}); weights {r['weights']} B "
              f"(spec count {r['spec_bytes']}); cache {r['cache_bytes']} B "
              f"(spec count {r['cache_spec_bytes']}); peak "
              f"{r['peak'] / 2**30:.2f} GiB; load {r['load_s']:.1f} s; "
              f"collectives of a decode step "
              f"{json.dumps(r['counts']['decode'])}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch", "kernels", "csrc")):
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--paper-cpu"]:
        return paper_cpu_runs(sys.argv[2])
    if sys.argv[1:2] == ["--elastic-cpu"]:
        return elastic_cpu_runs(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--families-cpu"]:
        return families_cpu_runs(sys.argv[2])
    if sys.argv[1:2] == ["--moe-ranks"]:
        return moe_rank_run(sys.argv[2])
    if sys.argv[1:2] == ["--fsdp-ranks"]:
        return fsdp_rank_run(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--fsdp-dry"]:
        return fsdp_dry_rows(sys.argv[2])
    if sys.argv[1:2] == ["--tp-ranks"]:
        return tp_rank_run(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == ["--tp-dry"]:
        return tp_dry_rows(sys.argv[2])
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import torch_update as tu
    from repro_torch.kernels import vrl_update as vu

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    print(f"[1 device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}; nvidia-smi: {card}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    t0 = time.time()
    build.build_all()
    vu._lib()
    vu._comm_lib()
    vu._leaf_lib()
    fa._lib()
    ss._lib()
    print(f"[2 build] {', '.join(build.SOURCES)} built and loaded in "
          f"{time.time() - t0:.1f}s", flush=True)
    tensor_core_report(build)
    # the reference trains in full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if "--main-paths" in sys.argv[1:]:
        from repro_torch.launch import train as launch
        main_path_runs(dev, KernelChecks(vu, tu), tu, vu, launch)
        return 0
    if "--families" in sys.argv[1:]:
        families_phase(dev, vu, card)
        return 0
    if "--shards" in sys.argv[1:]:
        shards_phase(dev, vu, card)
        return 0
    if "--dryrun" in sys.argv[1:]:
        dryrun_phase(dev, vu, card)
        return 0
    if "--bf16" in sys.argv[1:]:
        bf16_phase(dev, vu, tu, card, KernelChecks(vu, tu))
        return 0
    if "--fsdp" in sys.argv[1:]:
        fsdp_phase(dev, vu, card)
        return 0
    if "--tp" in sys.argv[1:]:
        tp_phase(dev, card)
        return 0
    if "--backbone" in sys.argv[1:]:
        backbone_phase(dev, vu, fa, ss, card)
        return 0
    if "--ckpt" in sys.argv[1:]:
        ckpt_phase(dev, vu, card)
        return 0
    if "--elastic" in sys.argv[1:]:
        elastic_phase(dev, vu, card)
        return 0
    if "--lr-sweep" in sys.argv[1:]:
        for tag, path in (("b", path_b), ("f", path_f), ("j", path_j)):
            for lr in (1e-3, 1e-4, 1e-5):
                res = train_path(f"({tag}) γ={lr}", *path(lr), dev, vu,
                                 require_finite=False)
                print_path(res, f"; finite: {res['finite']}")
        return 0

    # ------------------------------------------------------ 3 kernels
    chk = KernelChecks(vu, tu)
    plain_moderate = moderate_checks(chk, vu, tu, dev)
    hier_moderate_checks(chk, dev)
    print(f"[3 kernels] {chk.count} checks bitwise equal to the plain "
          f"versions at (4, 65536, 256) and (3, 1237, 256), the hierarchy's "
          f"at (P, D, R) = {', '.join(map(str, HIER_MODERATE))}; plain at the "
          f"moderate shape: local {plain_moderate['fused_local_sgd']:.3f} "
          f"ms, sync {plain_moderate['fused_sync_vrl']:.3f} ms", flush=True)
    n_leaf = leaf_moderate_checks(chk, dev)
    print(f"[3 kernels] vrl_local_update, vrl_sync_update: {n_leaf} checks "
          f"bitwise equal to the plain versions at n = 1, 105, 1000, "
          f"2^16 + 3, (64, 64) and (4, 130, 7), fp32 and bf16 operands, "
          f"views off 16-byte alignment, x̂ broadcast over 4 workers, NaN "
          f"for NaN", flush=True)

    times, plain, library = full_shape(chk, vu, tu, dev)
    leaf_t, leaf_p, bounds = leaf_full_width(chk, vu, tu, dev)
    times.update(leaf_t)
    plain.update(leaf_p)
    shapes = {name: HIER_FULL if name in HIER_KERNELS else FULL
              for name in KERNELS
              if name not in LEAF_KERNELS | ATTN_KERNELS | SSD_KERNELS}
    bounds.update({name: bound_ms(*COSTS[name](*shape))
                   for name, shape in shapes.items()})
    for name in shapes:
        b, _ = bounds[name]
        print(f"[3 kernels] {name} at {shapes[name]}: {times[name]:.3f} ms "
              f"(bound "
              f"{b:.3f} ms, {100 * b / times[name]:.1f}% of 3.35 TB/s); "
              f"plain {plain[name]:.3f} ms (slice by slice); max abs err vs "
              f"plain "
              f"{chk.err[name]}", flush=True)
    print(f"[3 kernels] {chk.count} bitwise checks in all", flush=True)
    n_attn, attn_worst = attention_moderate_checks(dev)
    print(f"[3 kernels] flash_attention: {n_attn} checks of mha_flash (B "
          f"1-2, S 1, 100, 257, 512, D 16-128, GQA groups 1, 2, 7, causal "
          f"on and off, window None, 16, 64; q · 10; D 128 at S 2048) and "
          f"of the (BH, S, D) wrapper "
          f"against the plain version within the tolerance: fp32 max abs "
          f"err {attn_worst[torch.float32][0]:.3e}; bf16 "
          f"{attn_worst[torch.bfloat16][0]:.3e} "
          f"({attn_worst[torch.bfloat16][1]} elements one bf16 ulp apart)",
          flush=True)
    attn_launches, attn_rows = attention_full_width(dev)
    attn_main = attn_rows["qwen2-0.5b", torch.float32, None]
    attn_bf16 = attn_rows["qwen2-0.5b", torch.bfloat16, None]
    times["flash_attention"] = attn_main["ms"]
    plain["flash_attention"] = attn_main["plain"]
    library["flash_attention"] = attn_main["library"]
    bounds["flash_attention"] = (attn_main["bound"], attn_main["by"])
    chk.err["flash_attention"] = max(r["err"] for r in attn_rows.values())
    # the redesigned kernels' second bound (the first port's, fp32 on the
    # CUDA cores); flash_attention's bf16 row
    extra = {"flash_attention": {
        "bound_share": attn_main["bound"] / attn_main["ms"],
        "cuda_core_bound_ms": attn_main["core_bound"],
        "cuda_core_bound_share": attn_main["core_bound"] / attn_main["ms"],
        "bf16_ms": attn_bf16["ms"], "bf16_bound_ms": attn_bf16["bound"],
        "bf16_library_ms": attn_bf16["library"]}}
    n_ssd, ssd_worst = ssd_moderate_checks(dev)
    print(f"[3 kernels] ssd_scan: {n_ssd} checks of ssd_chunk_scan (B 1-2, "
          f"H 1, 3, 32, P 16, 64, N 8, 128, Q 16, 64, 256 with 1-8 chunks, "
          f"ragged L, a_log + 1.5, mixed dtypes) and of the (BH, L, P) "
          f"wrapper against the "
          f"plain version within the tolerance: fp32 max abs err "
          f"{ssd_worst[torch.float32][0]:.3e} "
          f"({ssd_worst[torch.float32][1]:.3f} of the bound); bf16 "
          f"{ssd_worst[torch.bfloat16][0]:.3e} "
          f"({ssd_worst[torch.bfloat16][1]:.3f})", flush=True)
    ssd_launches, ssd_rows = ssd_full_width(dev)
    ssd_main = ssd_rows[torch.float32]
    times["ssd_scan"] = ssd_main["ms"]
    plain["ssd_scan"] = ssd_main["plain"]
    library["ssd_scan"] = None
    bounds["ssd_scan"] = (ssd_main["bound"], ssd_main["by"])
    chk.err["ssd_scan"] = max(r["err"] for r in ssd_rows.values())
    extra["ssd_scan"] = {
        "bound_share": ssd_main["bound"] / ssd_main["ms"],
        "cuda_core_bound_ms": ssd_main["core_bound"],
        "cuda_core_bound_share": ssd_main["core_bound"] / ssd_main["ms"],
        "bf16_ms": ssd_rows[torch.bfloat16]["ms"],
        "bf16_bound_ms": ssd_rows[torch.bfloat16]["bound"]}
    extra["flash_attention"]["wide"] = attention_wide(dev)
    extra["ssd_scan"]["wide"] = ssd_wide(dev)

    # the paper's runs on the CPU, in a child process beside phases 4-5
    paper_cpu = start_paper_cpu()
    try:
        return main_paths(dev, card, chk, times, plain, library, bounds,
                          extra, attn_launches, ssd_launches, paper_cpu)
    finally:
        if paper_cpu[0].poll() is None:
            paper_cpu[0].kill()
            paper_cpu[0].wait()


def main_path_runs(dev, chk, tu, vu, launch) -> dict:
    """Phase 4's training paths, in order, each one's seconds (its set-up
    and checks included) printed at the end; returns their results by
    key."""
    res, secs = {}, {}

    def run(key, fn, *args, **kw):
        t0 = time.time()
        res[key] = fn(*args, **kw)
        secs[key] = time.time() - t0
        return res[key]

    run("v", cli_path, "vrl_sgd+sgd", MAIN_ARGS, MAIN_LAUNCHES, launch, vu)
    print_path(run("a", train_path, "(a) bvr_l_sgd+adam", *PATH_A, dev, vu),
               "; " + check_sums(res["a"]))
    run("b", train_path, "(b) easgd+momentum", *path_b(EASGD_LR), dev, vu,
        after=easgd_sync_check(chk, tu))
    print_path(res["b"], res["b"]["note"])
    paths = comm_paths()
    res_c = run("c", train_path, "(c) vrl_sgd+sgd, int8", *paths["c"], dev,
                vu, watch=ef_identity_watch)
    worst = max(res_c["watched"], key=lambda r: r["off"] / r["limit"])
    if not any(r["ef_term"] > 10 * r["limit"] for r in res_c["watched"]):
        raise AssertionError(f"path (c): the EF term never stands above the "
                             f"rounding: {res_c['watched']}")
    print_path(res_c, wire_note(paths["c"][0])
               + f"; at each of the {len(res_c['watched'])} syncs Σ_i "
               f"Δ_i moved by the EF term Σ_i (e_i − e'_i)/(k γ) (largest "
               f"{max(r['ef_term'] for r in res_c['watched']):.3e}) to "
               f"within {worst['off']:.3e} <= {worst['limit']:.3e}")
    res_d = run("d", train_path, "(d) bvr_l_sgd+sgd, topk:32, overlap",
                *paths["d"], dev, vu)
    print_path(res_d, wire_note(paths["d"][0]) + "; after the last fold "
               + check_sums(res_d))
    run("e", cli_path, "(e) vrl_sgd+sgd, --overlap", PATH_E_ARGS,
        PATH_E_LAUNCHES, launch, vu)
    print_path(run("f", train_path, "(f) local_sgd+sgd, overlap",
                   *paths["f"], dev, vu))
    run("g", cli_path, "(g) hier_vrl_sgd+sgd (2, 2)", *PATH_G, launch, vu,
        grid=(2, 2))
    run("h", cli_path, "(h) hier_vrl_sgd+sgd (2, 2), --overlap", *PATH_H,
        launch, vu, grid=(2, 2))
    run("m", cli_path, "(m) hier_vrl_sgd+sgd (2, 2), --compress int8",
        *PATH_M, launch, vu, grid=(2, 2))
    run("n", cli_path, "(n) hier_vrl_sgd+sgd (2, 2), --compress int8 "
        "--compress2 topk:32 --overlap --deadline 0.25", *PATH_N, launch, vu,
        grid=(2, 2), misses=PATH_N_MISSES)
    run("o", cli_path, "(o) hier_vrl_sgd+sgd (2, 2), --compress topk:32",
        *PATH_O, launch, vu, grid=(2, 2))
    res_i = run("i", train_path, "(i) vrl_sgd+adam+sm3", *PATH_I, dev, vu,
                after=sm3_note)
    print_path(res_i, "; " + check_sums(res_i) + res_i["note"])
    run("j", train_path, "(j) hier_vrl_sgd+momentum (2, 2)",
        *path_j(HIER_MOMENTUM_LR), dev, vu)
    run("k", train_path, "(k) hier_vrl_sgd+adam (2, 2)",
        *hier_path(dict(inner_optimizer="adam"), MAIN_LR,
                   "fused_hier_local_adam"), dev, vu)
    run("l", train_path, "(l) hier_vrl_sgd+adam+sm3, bf16 mu (2, 2)",
        *hier_path(dict(inner_optimizer="adam", sm3=True,
                        moment_dtype="bfloat16"), MAIN_LR,
                   "fused_hier_local_adam_sm3"), dev, vu, after=sm3_note)
    for key in "jkl":
        print_path(res[key], "; " + check_hier_sums(res[key])
                   + res[key]["note"])
        print_rounds(res[key])
    # the per-leaf executor through the CLI (no kernel launched), then the
    # tree-update API's VRL-SGD rounds
    run("p", cli_path, "(p) vrl_sgd+sgd, --backend reference", PATH_P, {},
        launch, vu)
    run("q", cli_path, "(q) hier_vrl_sgd+sgd (2, 2), --backend reference "
        "--compress int8", PATH_Q, {}, launch, vu, grid=(2, 2))
    run("r", tree_api_path, dev, vu)
    # (u) mamba2-370m trains through the CLI: the flat engine's kernels;
    # the model's own ssd_chunked scan, as in the reference
    run("u", cli_path, f"(u) {MAMBA} vrl_sgd+sgd", MAMBA_ARGS,
        MAMBA_LAUNCHES, launch, vu, rounding=True)
    print(f"[4 main paths] seconds per path (set-up and checks included; "
          f"all but vrl_sgd+sgd (v) and (u) at {CUT_LAYERS} of qwen2-0.5b's "
          f"24 layers): {json.dumps({k: round(v, 1) for k, v in secs.items()})}"
          f", {sum(secs.values()):.1f} in all", flush=True)
    return res


def main_paths(dev, card, chk, times, plain, library, bounds, extra,
               attn_launches, ssd_launches, paper_cpu) -> int:
    """Phases 4 to 6 and the closing lines."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import torch_update as tu
    from repro_torch.kernels import vrl_update as vu
    from repro_torch.launch import train as launch

    # ------------------------------------------------------ 4 main paths
    print(f"[4 main paths] from {time.time() - START:.1f} s of the script, "
          f"the paper's CPU runs in a child process beside them",
          flush=True)
    res = main_path_runs(dev, chk, tu, vu, launch)
    # the serve CLI at full width (no kernel: the reference's serving path
    # runs none); mha_flash's and ssd_chunk_scan's launches come from
    # their paths in phase 3
    serve_path("(s) serve", "qwen2-0.5b", vu, fa, ss)
    serve_path("(t) serve", "granite-3-2b", vu, fa, ss)
    serve_path("(v) serve", MAMBA, vu, fa, ss, MAMBA_SERVE_ARGS)
    # each kernel's launches on the first path that runs it
    main_launches = {"flash_attention": attn_launches,
                     "ssd_scan": ssd_launches}
    for res_p in res.values():
        for name, n in res_p["launches"].items():
            main_launches.setdefault(name, n)

    # ------------------------------------------------------ 5 small input
    small_input_agreement(dev)
    hier_small_input(dev)
    ref_small_input(dev)
    serve_small_input(dev)
    ssm_small_input(dev)

    # ------------------------------------------------------ 6 the paper
    cpu = paper_cpu_result(*paper_cpu)
    t6 = time.time() - START
    print(f"[6 paper] from {t6:.1f} s of the script; its CPU runs took "
          f"{cpu['seconds']:.1f} s beside phases 4-5", flush=True)
    paper_fig1(dev, vu, cpu, card)
    paper_figures(dev, cpu, card)
    paper_width(dev, vu, card)
    print(f"[6 paper] {time.time() - START - t6:.1f} s on the card; the "
          f"script {time.time() - START:.1f} s", flush=True)

    # ------------------------------------------------------ 7 mesh
    mesh_paths({"main": res["v"], "e": res["e"], "g": res["g"]})

    # ------------------------------------------------------ 8 backbone
    backbone_phase(dev, vu, fa, ss, card)

    # ------------------------------------------------------ 9 checkpoints
    ckpt_phase(dev, vu, card)

    # ------------------------------------------------------ 10 elastic
    elastic_phase(dev, vu, card)

    # ------------------------------------------------------ 11 families
    families_phase(dev, vu, card)

    # ------------------------------------------------------ 12 shards
    shards_phase(dev, vu, card)

    # ------------------------------------------------------ 13 dry run
    dryrun_phase(dev, vu, card)

    # ------------------------------------------------------ 14 bf16
    bf16_rows, bf16_launches = bf16_phase(
        dev, vu, tu, card, chk, times, res["v"].get("peak_gib"))

    # ------------------------------------------------------ 15 fsdp
    fsdp_launches = fsdp_phase(dev, vu, card)

    # ------------------------------------------------------ 16 tp
    tp_phase(dev, card)

    kernels = []
    for name in KERNELS:
        b, by = bounds[name]
        src, ref = KERNEL_SOURCES[name]
        kernels.append({"name": name, "route": "cuda", "source": CSRC + src,
                        "replaces": ref,
                        "launches": main_launches[name],
                        "max_abs_err": chk.err[name], "ms": times[name],
                        "plain_ms": plain[name], "bound_ms": b,
                        "bound_by": by, "library_ms": library[name],
                        **extra.get(name, {})})
        if name in bf16_rows:
            # phase 14: bf16 parameters, gradients and x̂ with an fp32 and a
            # bf16 Δ/B; launches from (ba)'s bf16 training
            kernels[-1]["bf16"] = {
                "launches": bf16_launches.get(name, 0),
                "max_abs_err": chk.err[name],
                "delta_fp32": bf16_rows[name]["fp32"],
                "delta_bf16": bf16_rows[name].get("bf16")}
        if name in fsdp_launches:
            # phase 15: (bb)'s one worker over two fsdp ranks (rank 0)
            kernels[-1]["fsdp_launches"] = fsdp_launches[name]
    print(nvidia_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
