#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage: python3 chip_smoke.py     (from the repository root; needs one CUDA device)

Drives the port's paths at full width, with random weights from seeded
``torch.Generator``s: the FQSS-8bit ConvTasNet serving forward, its KD
train step, and its int8 serving engine and evaluation (512 filters,
bottleneck 128, hidden 512, 8 blocks x 3 repeats), then the FQSS-8bit
DPTNet serving path (``configs/dptnet_2spks_8k.yaml``'s model: encoder 256,
features 64, LSTM hidden 128, 6 dual-path layers, segments of 250), then the
FQSS-8bit Sepformer serving path (``configs/sepformer_2spks_8k.yaml``'s
model: 256 filters, 8 heads, 2 dual-path blocks of 8 + 8 transformer layers,
feed-forward 1024, chunks of 250), then the KD training of both, then the
fused fake-quant matmul (K3) of their bias-free 1x1 convs, streaming serving
and ``--engine auto`` for all three models, then bf16 compute
(``compute_dtype: bfloat16``) on the three models' serving path with the bf16
routes of K5, K3 and K8, then ConvTasNet-music (``configs/convtasnet_music.yaml``)
serving through every engine, its evaluation, KD training and recipe, then HTDemucs
(``configs/htdemucs.yaml``) serving through every engine and its evaluation, then its training (the GELU route of
K5-bwd, the KD step, the ``-env htdemucs`` recipe), then checkpoint import into the five models (reference ``.pth``
files and the JAX package's ``.npz`` exports through ``create_pretrained_model``, ``infer`` and ``pretrained:``); all
with n_splitter = n_combiner = 2 and 8-bit weights and activations, then data parallelism on two ranks sharing the
card. It prints one line per phase, a ``[time]`` line
after each group of phases, and lets any failure propagate:

0. device: the card's name and power limit (nvidia-smi); TF32 off.
1. build: compile ``fqss_tpu_torch/csrc/*.cu`` with nvcc, one process per source;
   ptxas's registers and spills, and for each qat_dense_kernel
   instantiation its tile, layouts and epilogue, for each LSTM and int8
   kernel instantiation its tile and shared memory, for each attention
   kernel instantiation its head width (a spill fails the phase; for the
   attention kernel, at the main path's widths d 16 and 32); the bf16 routes'
   instantiations are marked so.
2. kernels vs their plain PyTorch versions on the card, bitwise
   (``torch.equal``), at the main path's shapes, with planted edge and
   half-step tie values; CUDA-event times of both. The grouped weight
   kernel at each model's full weight set (ConvTasNet, DPTNet, Sepformer):
   the observing call in train mode (outputs, the observers' written ranges
   and flags) and the serving call with planted ties, bitwise; the kernel's
   time alone, the wrapper's and the model's weight pass (host clock).
3. the full-width model: an observer pass sets the ranges, then one forward
   of 32 x 12 s at 8 kHz; the act launch counter must rise by exactly the
   number of act quantizer modules, the weight counter by one (the grouped
   launch of the model's weight pass).
4. card vs CPU on the same weights (1 x 1 s): SNR >= 20 dB per output.
5. the folded engine: bitwise equal to the fake-quant forward, with no
   weight-kernel launch.
6. three 20 s requests through ``fqss_tpu_torch.infer`` (folded engine, OLA),
   with the ``model_cfg`` of ``configs/convtasnet_2spks_8k.yaml`` pointed at
   the phase-3 weights.
7. throughput of both engines at 32 x 12 s.
8. the backward kernels vs their plain versions on the card: the input
   gradients bitwise, the range gradients (sums) within SUM_RTOL of the sum
   of the terms' magnitudes, at the train step's largest activation, odd
   sizes and the 7 weight shapes on channel axes 0 and 1; the grouped
   backward at phase 2's three weight sets, with absent and transposed
   gradients, and in the observing state (dw = g, range gradients 0);
   CUDA-event times.
9. KD training at full width: student and float teacher from
   ``create_model_and_teacher``, 8 steps of 2 x 3 s through
   ``make_train_step`` with a 3-step observer window; every step must launch
   the act kernel once per act quantizer module and its backward once per
   act quantizer whose output reaches the loss, and the grouped weight
   kernels once each way.
10. card vs CPU: one post-window step from the same state at 1 x 1 s; loss
    and whole-gradient cosine within LOSS_DB_TOL and GRAD_COS_MIN.
11. train-step time at 16 x 3 s: ms per step, seconds of audio trained per
    second, peak device memory.
12. the int8 kernel (K4) vs its plain version on the card, bitwise, at the
    engine's three full-width shapes (M = 32 x 11999 rows; K -> N of
    512 -> 128, 128 -> 512, 128 -> 1024), with planted extremes (rows of
    -128 against columns of -128 and 127) and outputs on exact half-step
    ties, and at odd sizes; CUDA-event times of the kernel, the plain
    version and ``torch._int_mm`` (the product alone).
13. the int8 engine at full width from phase 3's model, float32 and
    bfloat16 operands, 32 x 12 s: K4 launches = the 1x1 convs of the module
    tree (74) and no fake-quant launch; output against phase 3's at the
    fake-quant forward's own noise floor (phase 4's card-vs-CPU distance;
    see INT8_FLOOR); card vs CPU for both engines at 1 x 1 s (see
    INT8_CARD_VS_CPU); the same rule for a model with the combiner's trained
    residual decoder (``train_res_dec``), on 4 x 12 s.
14. three 20 s requests through ``fqss_tpu_torch.infer`` with the int8
    engine.
15. throughput of the int8 engine (float32 and bfloat16) at 32 x 12 s.
16. evaluation: ``fqss_tpu_torch.val.evaluate`` of the fake_quant and int8
    engines on a LibriMix-layout folder of 4 synthetic 3 s mixtures:
    finite metrics, mean SI-SDR within EVAL_SISDR_DB of each other.
17. the LSTM kernel (K7 both directions, K6 one) vs its plain version on the
    card, max |difference| <= LSTM_TOL, at DPTNet's row and column shapes
    (T 250 x B' 2064 and T 258 x B' 2000, H 128), at the LSTMs of a streamed
    16000-sample window at batch 1 (T 250 x B' 130 and T 130 x B' 250) and at
    T 7 x B' 3 x H 96, with the launch plan of each (cluster size, row tile,
    CTAs);
    how far a recurrence with the i and f gates swapped, or with the reverse
    direction left unflipped, reads (what the bound must catch); CUDA-event
    times of the kernels, the plain versions and cuDNN's ``nn.LSTM`` (same
    weights and input, its own input projection) beside the port's QLSTM
    (projection + K7).
18. the full-width DPTNet from ``create_pretrained_model``, ranges from the
    config's 50-step observer window (on 2 x 4 s), one forward of 8 x 4 s:
    output [8, 2, 32000], finite; the act launch counter rises by the act
    quantizer modules that run (all but the attention's two no-op sites of
    each layer, its head quantizer, whose grid K8 applies, the QDense
    layers', whose grids K5 applies, and BN's, whose grid K3 applies), the
    weight counter by one (every weight grid in the grouped launch, K5's
    and K3's off), K7 by 12, K6 by 0, K8 (the fused attention) by 12, K5 by
    13 and K3 by 1 (BN).
19. card vs CPU on the same weights (1 x 1 s): SNR >= 20 dB per output.
20. the folded DPTNet: bitwise equal to the fake-quant forward, no
    weight-kernel launch, K5 and K3 with their weight grids off.
21. three 20 s requests through ``fqss_tpu_torch.infer`` (folded, OLA) with
    ``configs/dptnet_2spks_8k.yaml``'s ``model_cfg``.
22. K4 bitwise against its plain version at the DPTNet engine's shapes and
    epilogues (identity, ReLU, tanh, sigmoid), its GB/s and share of the
    bytes bound at each, summed over a forward's 28 launches; the DPTNet int8 engine,
    float32 and bfloat16 operands, 8 x 4 s: K4 launches = its int8 products
    (``dptnet_int8_sites``), K7 12, the LSTMs' 12 output quantizers and no
    other fake-quant launch; output against phase 18's at the fake-quant
    forward's floor (phase 19) with phase 13's rule; card vs CPU at 1 x 1 s
    >= 20 dB per output.
23. throughput of the DPTNet engines (fake_quant, folded, int8 f32 and bf16)
    at 8 x 4 s.
24. the fused attention kernel (K8) vs its plain version on the card, at the
    Sepformer's intra- and inter-chunk shapes, DPTNet's row and column shapes
    (all recomputed from the models) and at BH 3 x Lq 37 x Lk 53 x d 24, the
    first query of every head planted 100x (logits far past expf's range),
    through both entries (``[BH, L, d]``, and the packed one on the views of
    an in-projection ``[B, L, 3E]`` that QMultiheadAttention hands it, bitwise
    equal): float heads within ATTN_REL_TOL of their magnitude, the planted
    rows too (their distance from the float64 attention printed beside the
    plain version's); on the head grid within one step, at most
    ATTN_GRID_SHARE a step apart, and each equal to its own float head put
    through the plain grid; how far a core with K and V swapped, or one
    without the max subtraction, reads; the backward of both
    autograd.Functions equal to the plain composition's gradient; the launch
    plan of each shape; CUDA-event times of both entries, the plain version
    (median of 7) and ``F.scaled_dot_product_attention`` + K1 (the library
    call), with the float32 bound, the 3xTF32 one and the kernel route's
    (``attention_route_bound``), summed per Sepformer and per DPTNet forward.
25. the full-width Sepformer from ``create_pretrained_model``, ranges from the
    config's 50-step observer window on 2 x 4 s, one forward of 8 x 4 s:
    output [8, 2, 32000], finite; the act launch counter rises by the act
    quantizer modules that run (not the QDense layers': K5 applies their
    grids; not the masker conv1d's: K3 does), the weight counter by one (the
    grouped launch), K8 by 32, K5 by 65 and K3 by 1.
26. card vs CPU on the same weights (1 x 1 s): SNR >= SEP_CARD_VS_CPU_DB per
    output; the float model on the same weights >= SEP_FLOAT_CARD_VS_CPU_DB.
27. the folded Sepformer: bitwise equal to the fake-quant forward, no
    weight-kernel launch (the trained residual decoder included).
28. three 20 s requests through ``fqss_tpu_torch.infer`` (folded, OLA) with
    ``configs/sepformer_2spks_8k.yaml``'s ``model_cfg``.
29. K4 bitwise against its plain version at the Sepformer engine's seven
    shapes and epilogues (the in-projection with its three output grids, the
    end conv with ReLU), its GB/s and share of the bytes bound at each,
    summed over a forward's 131 launches; the Sepformer int8 engine, float32 and bfloat16
    operands, 8 x 4 s: K4 launches = 4 per transformer layer + 3 (131), no
    other launch; output against phase 25's at the fake-quant forward's floor
    (phase 26) with phase 13's rule; card vs CPU at 1 x 1 s >= 20 dB.
30. throughput of the Sepformer engines (fake_quant, folded, int8 f32 and
    bf16) at 8 x 4 s.

31. the fused QAT dense kernel (K5) and its backward (K5-bwd) vs their plain
    versions on the card, at the QDense shapes of DPTNet (256 -> 64, 64 -> 128)
    and the Sepformer (256 -> 1024, 1024 -> 256, 256 -> 512) at the training
    batch (recomputed from the models) and at odd sizes, with planted
    half-step ties and clip extremes, for every combination of the two grids
    and their observing flags: the float pre-activation within DENSE_RTOL, each
    quantized output its own pre-activation on K1's grid, at most
    DENSE_GRID_SHARE a step apart; dx, dw, db and the range gradients within
    their bounds; two runs of each bitwise equal; the mask pass's gm exactly g
    times the mask of the forward's own pre-activation; CUDA-event times of
    both, the plain versions and the library calls (addmm + K1; two mm +
    K1-bwd), with the achieved TFLOP/s and the shares of the float32 bound and
    of the 3xTF32 route's bound (3 TF32 products a float32 one at 495 TFLOP/s,
    or the bytes).
32. the K7/K6 backward: the autograd wrapper's gradients against the plain
    recurrence's at DPTNet's training shapes and an odd one (LSTM_GRAD_TOL).
33. DPTNet and Sepformer KD training at full width: student and float teacher
    from ``create_model_and_teacher`` with the configs' ``model_cfg``, 8 steps
    at the configs' batch 1 (3 s and 4 s) through a 3-step observer window:
    every step launches K5 per QDense forward (student and teacher), K5-bwd
    per QDense, K7 and K8 per module, K3 per bias-free 1x1 conv of the
    teacher (it runs without gradient; the student's take F.conv1d and the
    quantizer kernels), K1 per remaining act quantizer module and K1-bwd per
    act quantizer reaching the loss, the grouped weight kernels once each
    way; finite losses.
34. card vs CPU: one post-window step at 1 x 1 s, the quantized model and its
    float version, loss and whole-gradient cosine within TRAIN_CARD_VS_CPU
    (DPTNet cut to the first 2 of phase 33's 6 dual-path layers, the Sepformer
    to the first of its 2 blocks).
35. train-step time and peak memory of both models at batch 1 and the
    largest of 2, 4, 8 that fits (DPTNet's steps timed once after a warm-up,
    the Sepformer's three times).
36. one recipe epoch of each config (``-env asteroid`` DPTNet,
    ``-env speechbrain`` the Sepformer) through ``python -m
    fqss_tpu_torch.train`` on a mini LibriMix, the two processes side by side.

37. the fused fake-quant matmul (K3) vs its plain version on the card, at the
    shapes phases 18 and 25 gave it (DPTNet's BN [8, 256, 31999] -> 64, the
    Sepformer masker's conv1d [8, 256, 3999] -> 256) and at odd sizes, with
    planted half-step ties and clip extremes, for every combination of the two
    grids and their observing flags: the float outputs within DENSE_RTOL of
    the sum of the terms' magnitudes, each quantized output its own float
    output on K1's grid, at most DENSE_GRID_SHARE a step apart, the planted
    values exact, two runs bitwise equal; CUDA-event times of K3, its plain
    version and ``torch.matmul`` + K1 (the library call), with the achieved
    TFLOP/s and both bounds (phase 31's).
38. streaming: a 20 s mixture in pushes of 1600 samples (200 ms) through
    ``infer.stream_file`` with 16000-sample windows, for each model's folded
    engine and ``auto``: the drained stream within STREAM_TOL of
    ``ola_infer(chunk_batch=1)`` on the card; each window's forward timed by
    CUDA events (p50, p90 over 14 windows).
39. ``--engine auto`` through the infer entry for each model: the table's
    path (``serve/autopath.py``), bitwise equal to the folded engine, weight-
    grid launches only where that path is fake_quant; three 20 s requests.

40. bf16 compute, the flagship: bench.py's configuration (ConvTasNet
    FQSS-8bit with ``compute_dtype="bfloat16"``) on phase 3's weights and
    ranges, 32 x 12 s: the launches of the module tree (K1 per act quantizer,
    one grouped weight launch, the bf16 routes only), the distance from the
    float32 forward, the folded engine bitwise equal with no weight launch,
    card vs CPU at 1 x 1 s >= BF16_CARD_VS_CPU_DB, the forwards' times in
    turns with the float32 forward; one 20 s request through
    ``python -m fqss_tpu_torch.infer`` with a bf16 config (its own process).
41. DPTNet in bf16 at 8 x 4 s on phase 18's weights and ranges: as phase 40,
    the launches those of phase 18 with K5, K3 and K8 on their bf16 routes
    (``dense_bf16``, ``qmatmul_bf16``, ``attention_bf16``) and none on their
    float32 routes.
42. the Sepformer in bf16 at 8 x 4 s on phase 25's weights and ranges, as 41.
43. the bf16 routes of K5 and K3 against their plain versions at the shapes
    phases 40-42 gave them and at odd ones, every grid and observing-flag
    combination, with phases 31 and 37's rules on the rounded operands; K8's
    bf16 route through both entries at the bf16 forwards' attention shapes
    and ATTN_ODD, planted rows included, by ATTN_BF16_TIE_ULPS's rule; CUDA-
    event times of each bf16 route, its float32 route at the same shapes, the
    bf16 plain version and, where torch has one, the library call, with the
    bf16 bound (989 TFLOP/s or the bytes).

44. ConvTasNet-music at full width (``configs/convtasnet_music.yaml``'s model:
    256 filters, bottleneck 256, hidden 512, 4 repeats x 10 blocks, 4 stems,
    stereo) from ``create_model``, ranges from the config's 50-step observer
    window over 2 x 2 s of ``synth_music_batch`` stems, one forward of one
    OLA batch of a track, 8 x 441,000 samples (10 s at 44.1 kHz): output
    [8, 4, 2, 441000], finite; K1 per act quantizer module but the 41 K3
    convs', one grouped weight launch, K3 41 (the bottleneck and every
    block's pointwise).
45. on one chunk (1 x 441,000): at full depth the card's own floor, its
    forward against its own forward of the chunk times (1 + 2^-22) (random
    weights through 40 blocks put it near 18 dB); card vs CPU at one repeat
    (10 blocks), SNR >= 20 dB per output.
46. the folded model: bitwise equal to the fake-quant forward, no weight
    launch.
47. the int8 engine, float32 and bfloat16 float products, 8 x 441,000: K4 83
    (the bottleneck, 40 conv1x1, 40 pointwise, the mask conv, the decoder)
    and no other launch; against the fake-quant forward at phase 45's floor
    with phase 13's rule; card vs CPU at 1 x 2 s and one repeat within the
    engine's own floor there (MUSIC_FLOOR_RULE).
48. throughput at 8 x 441,000 of fake_quant, folded, int8 f32 and bf16 and
    the fake_quant model in bf16 compute.
49. K3 against its plain version at the music forward's shapes ([8, 256,
    44099] -> 256 once, [8, 512, 44099] -> 256 40 times; phase 37's rules),
    K4 at the music engine's (phase 22's rule; the decoder's N = 40 over
    1,411,168 rows), with times per forward; the grouped K2 and K2-bwd at the
    music model's weight set run in phases 2 and 8.
50. ``val.evaluate`` (MUSDB NSDR) of fake_quant and int8 on a MUSDB-layout
    test split of two 12 s synthetic tracks: finite, NSDRs within
    EVAL_NSDR_DB.
51. the tasnet KD step (``make_music_train_step``: the config's
    augmentation, the float teacher, the pow10 L1 loss, clip 5.0) at full
    width on 6 s windows: batch 1's peak memory, then 8 steps at the largest
    of 4, 2, 1 that fits, each launching K1 and K1-bwd per act quantizer,
    the grouped K2 and K2-bwd once each and K3 for the teacher's 41 1x1
    convs; step time and peak memory.
52. card vs CPU on one post-window step at 1 x 1 s: the L1 losses within
    LOSS_DB_TOL dB; the whole-gradient cosine within the card's own floor
    (its step on the stems times (1 + 2^-22), by MUSIC_FLOOR_RULE).
53. one epoch of ``python -m fqss_tpu_torch.train -env tasnet`` with the
    full-width model on a mini MUSDB at 44.1 kHz (JSON config); its process
    runs beside phase 64's, after phase 63.
54. the full-width HTDemucs of ``configs/htdemucs.yaml`` (HTDEMUCS_CFG),
    ranges from the config's 50-step observer window on 2 x 2 s of stems,
    one forward of 8 x 343,980 (``testing_cfg.segment_samples``) with
    ``train=False``, which pads to 441,000: output [8, 4, 2, 343980],
    finite; K1 = the act quantizers but the QDense layers' and the
    attentions' no-op and head sites, one grouped weight launch, K5 10
    (linear2), K5's GELU route 10 (linear1), K8 10 (6 self-attention at
    3448 and 1723 tokens, 4 cross-attention 3448 x 1723 and 1723 x 3448,
    BH 64, d 48 on the D 64 instantiation); peak memory.
55. on one chunk: at full depth the card's own floor (its forward on the
    input times 1 + 2^-22); card vs CPU >= 20 dB at one transformer layer
    (HTD_SHALLOW).
56. folded: bitwise equal to the fake-quant forward, no weight launch.
57. the int8 engines (float32, bfloat16 float products): K4 44 (10 with the
    GELU epilogue), K8 10 (its bf16 route in bf16), K1 for the folded conv
    branches' act quantizers only; against the fake-quant forward by the
    floor rule of phase 13 at phase 55's floor; card vs CPU on one chunk at
    HTD_SHALLOW within the engine's own floor there.
58. throughput and peak memory of fake_quant, folded, int8 f32 and bf16 at
    8 x 343,980.
59. K8 (both routes) at the four attention shapes of phase 54's forward
    against its plain version (phase 24's and 43's rules) with SDPA + K1
    beside it; K5 and its GELU route at linear2's and linear1's shapes
    (phase 31's rules, the GELU route's bound GELU_SLOPE times larger) with
    addmm (+ F.gelu) + K1; K4 and its GELU epilogue at the int8 engine's
    shapes, bitwise, with torch._int_mm; times per forward.
60. ``python -m fqss_tpu_torch.val`` (MUSDB NSDR), fake_quant and int8, in
    subprocesses on a MUSDB-layout split of two 12 s synthetic tracks:
    finite, int8 within EVAL_NSDR_DB of fake_quant.
61. K5-bwd's GELU route (the mask pass with the GELU and its derivative,
    then dx, dwq) against its plain version at linear1's training shapes
    (E 384 -> 1536 at phase 62's token counts), every grid and observing-flag
    combination, by phase 31's backward rules with the bounds GELU_SLOPE
    times larger; its time per step beside its bound and the library call
    (two torch.mm, torch's GELU backward and K1-bwd).
62. the htdemucs KD step (``make_music_train_step(is_htdemucs=True)``: the
    config's augmentation, ``train=True`` for student and teacher, the exp
    loss with source weights, the batch EMA of decay 0.9995) at full width on
    the config's 7.8 s windows (343,980 samples, shift 8192): batch 1's peak
    memory, then 8 steps at the largest of 4, 2, 1 that fits, each launching
    K1 and K1-bwd per act quantizer (no K1-bwd at the attentions' no-op
    sites), the grouped K2 and K2-bwd once each, K5 and K5-bwd 10 each
    (linear2; K5 10 more for the teacher), the GELU route's forward 20 and
    backward 10 (linear1), K8 20 (student and teacher); step time and peak
    memory.
63. card vs CPU on one post-window htdemucs step at 1 x 1 s: the L1 losses
    within LOSS_DB_TOL dB; the whole-gradient cosine within the two devices'
    own floors (each one's step on the stems times (1 + 2^-22), summed, by
    MUSIC_FLOOR_RULE; the note above HTD_RECIPE_SECONDS says why not the
    card's alone); the same at HTD_STEP_SHALLOW against the card's own floor
    alone (phase 52's rule), whose verdict it prints: that rule does not
    hold there, and the failure stands.
64. one epoch of ``python -m fqss_tpu_torch.train -env htdemucs`` with the
    full-width model on a mini MUSDB at 44.1 kHz (JSON config): one batch EMA
    and one epoch EMA, Repitch on; finite losses, the chosen model (bname)
    printed, the best and latest exports written; beside phase 53's process.
65. each of the five models at full width (the configs of phases 3, 18, 25,
    44 and 54) from a seeded float model written as a reference ``.pth``
    (wrapped in ``state_dict``, keys under ``model.``, a stray ``fmodel.``
    key; ``reference_state_dict``, which tests/test_torch_checkpoint_import.py
    holds to the JAX package's key maps) through ``create_pretrained_model``
    on the card: every float weight equal to the source's, the widened
    encoders' MSB planes the float kernels; the load time.
66. each model's served weights and ranges (phases 3, 18, 25, 44, 54) written
    as a JAX ``export_model`` ``.npz`` (``models/convert.py:*_to_jax``)
    through ``create_pretrained_model`` on the card: one serving forward
    bitwise equal to the source model's, with the same launches; the load
    time.
67. ``python -m fqss_tpu_torch.infer`` with ``model_cfg.model_path`` the
    flagship's ``.npz``, folded and int8, the two processes side by side.
68. one KD step of ``-env asteroid`` (the flagship) and of ``-env htdemucs``
    at batch 1 from a reference float ``.pth`` given as ``pretrained``, as the
    recipes give it to ``create_model_and_teacher``: the teacher equal to the
    pretrained model, the student's launches those of the module tree, a
    finite loss.
69. the reference's other quantizers on the flagship (``in_quant``,
    ``inout_nl_quant``: mu-law I/O grids, ``act_quantizer: mse``, a 3-step
    window): KD steps of 16 x 3 s, 3 inside the window, the host's MSE
    calibration (its seconds and quantizers), 5 after it, every step's
    launches those of the module tree (the mu-law sites' inner K1 and K1-bwd
    among them); the mu-law quantizer on the card against its plain version
    on the CPU; one MSE quantizer fed the same five activations on the card
    and on the CPU (bin counts, window ends and counter bitwise, the re-binned
    histogram within MSE_HIST_L1 of the total count); the calibrated step
    card vs CPU by phase 10's rule.
70. phase 69's calibrated flagship served at 32 x 12 s: fake_quant and folded
    bitwise equal, launches those of the module tree, card vs CPU >= 20 dB at
    one repeat of the TCN, the int8 engine refused (a mu-law output grid) and
    ``auto`` serving the folded model, the throughput of both, ``infer`` on the
    state written as a JAX ``.npz``, and the deploy grids of
    ``export_quantizer_grids`` by kind.
71. DPTNet (``configs/dptnet_2spks_8k.yaml``'s model) with ``train_res_dec``
    and ``act_quantizer: mse``: the grouped weight kernels at its 93 weight
    quantizers against their plain versions (phases 2 and 8's rules); KD
    steps of 1 x 3 s, 3 inside the window, the calibration, 1 after it, every
    step's launches those of the module tree (K5/K5-bwd under the MSE flag,
    K8 by the composition rule while the head quantizer observes); then at
    8 x 4 s fake_quant, folded (bitwise equal) and the int8 engines with the
    trained residual plane (phase 13's floor rule), card vs CPU (phase 19's
    rule), ``auto`` and the throughputs.
72. the LSTM kernel's static route (``QLSTM(mode="static")``'s cell, K7 both
    directions and K6 one) against its plain version at phase 17's shapes
    (DPTNet's row and column, the streamed window's, LSTM_ODD), on grids the
    window fits to each input, with the observer window closed (one launch)
    and closing after STATIC_WINDOW steps of the call (two launches and the
    EMA between): every output within one step of the output site's grid of
    the plain version's, at most STATIC_SHARE more than half a step apart,
    the ranges after the window within STATIC_RANGE_REL of each site's range
    width; the launch plans; CUDA-event times of the route, of K7's fused
    route on the same input and of the plain static recurrence (median), per
    DPTNet forward against the static route's bound.
73. DPTNet with ``lstm_mode: static``: STATIC_TRAIN_STEPS KD step(s) of 1 x 3 s
    at its first STATIC_TRAIN_LAYERS dual-path layer(s) from a fresh state (the
    sites' window closing in the first step's every LSTM call): the student's LSTMs
    on the static route, one launch a call and one more a call inside the
    window, the teacher's on K7, every other launch the module tree's, a
    finite loss; then phase 18's weights and ranges with the sites' window
    observed in one train-mode forward, served at 8 x 4 s: 12 static-route
    launches a forward and no fused or plain LSTM, folded bitwise equal, the
    int8 engine (float32 products) by phase 13's floor rule on the fake-quant
    forward's card-vs-CPU floor (phase 19's rule), the throughputs.
74. DPTNet with ``lstm_mode: dynamic`` (the plain loop of 12 dynamic grids a
    step, on every device) on phase 73's weights and act ranges: one serving
    forward at 8 x 4 s timed by CUDA events, with no LSTM kernel launch, and a
    profile of the loop's steps (kernels and device time a step); card vs CPU by
    phase 19's rule at its first DYNAMIC_CPU_LAYERS dual-path layers; one KD
    step of 1 x 3 s at its first DYNAMIC_TRAIN_LAYERS, a finite loss.
75. data parallelism (``fqss_tpu_torch/parallel/mesh.py``): two ranks, processes of this script
    (``--ddp-worker``) sharing cuda:0 over gloo, each with its rows of every global batch; the flagship's
    DDP_STEPS KD steps at 16 x 3 s through its observer window against one process on the same 16 rows, from the
    ranks' learned parameters before each step: every act observer's ranges and counter after each forward bitwise
    equal, the ranks' whole states bitwise equal, the loss within DDP_LOSS_DB, the whole-gradient cosine at least
    DDP_GRAD_COS; the step times of both (two ranks sharing a card: not a speed-up). The ranks and the one-process
    runs of 75-79 take cuDNN's deterministic algorithms (its default convolution backward sums with atomics).
    Then FSDP (``fqss_tpu_torch/parallel/fsdp.py``) on the same ranks: the same steps with the state sharded at JAX's
    min_size (the student, the teacher, Adam's moments), each from the DDP run's learned parameters: the act
    observers after every forward, the loss and the reduced gradients before the clip bitwise the DDP steps', the
    global norm within FSDP_NORM_REL, the state after each step bitwise where the clip does not bind, else within
    FSDP_STATE_REL of each tensor's largest magnitude; against one process by the rules above; each rank holding
    between steps exactly the replicated elements, 1/2 of each sharded one and the named persistent gather buffers.
76. the same steps on a one-rank NCCL group (every collective run): bitwise equal to the run without a group;
    first one step with cuDNN's defaults against itself. On the same group one FSDP step against the first step
    without a group (by phase 75's FSDP rules) and one single-stage pipeline call of two full-width transformer
    layers, bitwise the layers in order.
77. DPTNet with ``lstm_mode: static`` at one dual-path layer, a KD step of 2 x 1.5 s, one row a rank: the sites'
    ranges and counters after the forward bitwise equal to one process's.
78. ``ola_infer(mesh=...)`` of a 60 s mixture through phase 75's flagship, chunk_batch 8 a rank, against one process
    at 16 (the same blocks): bitwise equal.
79. the dynamic cell's reductions: a one-layer dynamic DPTNet's eval forward of 2 x 1.5 s, one row a rank, against
    one process: its time on both; the launches of each data-parallel path (on the ranks, summed) must include its
    kernels.
80. tensor parallelism (``fqss_tpu_torch/parallel/tp.py``): two ranks of this script (``--tp-worker``) sharing
    cuda:0 over gloo as a grid of tp 2, the full-width Sepformer of ``configs/sepformer_2spks_8k.yaml`` sharded
    over them (the projections by heads, ffn_in/ffn_out column/row), 2 x 4 s replicated over tp: the float
    forward at TP_FLOAT_DB or more against one process holding the whole weights, phase 25's calibrated QAT
    forward above TP_QAT_DB (JAX's TP rule), and TP_STEPS KD steps through the observer window against one process
    from the ranks' whole learned parameters before each step: each step's loss within TP_LOSS_DB and its
    whole-gradient cosine at least TP_GRAD_COS; the share of each step in the gloo tp sums. Its two ranks run side
    by side with phase 81's four (two groups on the one card), so the step times both log overlap.
81. the same on a dp 2 x tp 2 grid of four ranks, the Sepformer at one layer a block, one KD step of 2 x 4 s (one
    row a dp rank) by the same step rule; each tensor-parallel path (the ranks' launches, summed) must launch K5,
    K5-bwd, K8, K1, K1-bwd and the grouped K2/K2-bwd. This step is the dry run's phase 1 at full width; then the same
    ranks run the port's dry run itself (``fqss_tpu_torch/parallel/dryrun.py:run``, its four phases at the JAX
    function's sizes: the dp+tp step, the sharded OLA, the FSDP step, the 2-stage pipeline's forward and gradient),
    each finite, its dp+tp step and its FSDP step launching their kernels.
82. pipeline parallelism (``fqss_tpu_torch/parallel/pp.py``) on phase 81's four ranks: the first intra block of the
    calibrated Sepformer (phase 25's state; 8 layers) over 4 stages of 2 layers, 4 microbatches of the tokens it
    receives at 2 x 4 s (a forward hook: 68 sequences of 250), against the layers in order in one process: the float
    forward (the same weights in float layers) within PP_FWD_TOL absolute and relative, the QAT forward within PP_QAT_OF_MAX of max|y|, the float
    gradient of sum(y^2) within PP_GRAD_ATOL absolute and PP_GRAD_RTOL relative (JAX's rules), each forward's
    bitwise equality logged, beside two witnesses for the gradient: the stack on the microbatches in reverse order
    (the card's own floor for the rule), and the stack on each microbatch alone, its gradients summed as the
    pipeline sums them, to which the pipeline's gradients must be bitwise equal; every call must launch its kernels.
    The JAX rule's verdict on the gradient failed in every run (1-2 of 96 tensors, as does the first witness in some)
    and stands: it is printed beside the floor and repeated before the result, not raised (ROADMAP queue 3), as
    phases 63 and 69 do.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from fqss_tpu_torch import infer, val
from fqss_tpu_torch.data.musdb import make_mini_musdb
from fqss_tpu_torch.data.synthetic import synth_batch, synth_music_batch
from fqss_tpu_torch.models.convtasnet import ConvTasNet
from fqss_tpu_torch.models.convtasnet_music import ConvTasNetMusic
from fqss_tpu_torch.models.dptnet import DPTNet, split_segments
from fqss_tpu_torch.models.htdemucs import HTDemucs
from fqss_tpu_torch.models.sepformer import Sepformer, TransformerLayer
from fqss_tpu_torch.models import convert
from fqss_tpu_torch.models.factory import (create_model, create_model_and_teacher, create_pretrained_model,
                                           quant_spec_from_cfg)
from fqss_tpu_torch.nn.attention import QMultiheadAttention
from fqss_tpu_torch.data.librimix import make_mini_librimix
from fqss_tpu_torch.nn.layers import QConv1d, QDense
from fqss_tpu_torch.nn.nonlin import gelu as gelu_ref
from fqss_tpu_torch.nn.nonlin import gelu_grad
from fqss_tpu_torch.nn.lstm import QLSTM
from fqss_tpu_torch.ops import _build
from fqss_tpu_torch.ops import attention as k8
from fqss_tpu_torch.ops import fake_quant as fq
from fqss_tpu_torch.ops import int8_matmul as im
from fqss_tpu_torch.ops import lstm as lk
from fqss_tpu_torch.ops import qat_dense as qd
from fqss_tpu_torch.ops import qmatmul as qm
from fqss_tpu_torch.parallel import dryrun, fsdp, pp, shards, tp
from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.quant.fake_quant import bf16_round
from fqss_tpu_torch.quant import histogram
from fqss_tpu_torch.quant.calibration import calibrate_mse_quantizers, has_pending_mse
from fqss_tpu_torch.quant.export import export_quantizer_grids
from fqss_tpu_torch.quant.quantizers import (ActQuantizer, MseActQuantizer, WeightQuantizer, read_only, weight_pass,
                                             weight_quantizer_sites)
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.separation.ola import ola_infer
from fqss_tpu_torch.serve import BEST_PATHS, make_int8_engine
from fqss_tpu_torch.serve.autopath import auto_serving_model
from fqss_tpu_torch.serve.fold import fold_quantized_weights
from fqss_tpu_torch.train.checkpoints import jax_export_entries
from fqss_tpu_torch.train.recipes_music import _params_copy, make_music_optimizer, make_music_train_step
from fqss_tpu_torch.train import trainer as trainer_module
from fqss_tpu_torch.train.state import TrainState
from fqss_tpu_torch.train.trainer import TrainConfig, make_optimizer, make_train_step
from fqss_tpu_torch.utils.audio import read_audio, save_audio

SR = 8000
SEG = 96000  # 12 s at 8 kHz, as bench.py
BATCH = 32
# model_cfg of configs/convtasnet_2spks_8k.yaml, written out so that no YAML parser is needed.
MODEL_CFG = {
    "name": "ConvTasNet",
    "model_path": None,
    "n_src": 2,
    "kernel_size": 16,
    "stride": 8,
    "quantization": {
        "qat": True, "gradient_based": True, "weight_quant": True, "weight_n_bits": 8,
        "act_quant": True, "act_n_bits": 8, "in_quant": False, "in_act_n_bits": 8,
        "out_quant": True, "out_act_n_bits": 8, "n_splitter": 2, "n_combiner": 2, "observer": True,
    },
}
SPEC = QuantSpec(qat=True, observer=False, n_splitter=2, n_combiner=2, out_quant=True)
# Weight shapes of the full-width model (torch layout) and their channel axes.
WEIGHT_SHAPES = (
    ((512, 2, 16), 0),  # encoder
    ((128, 512, 1), 0),  # bottleneck, res and skip 1x1 convs
    ((512, 128, 1), 0),  # conv_in
    ((512, 1, 3), 0),  # depthwise conv
    ((1024, 128, 1), 0),  # mask conv
    ((512, 1, 16), 0),  # combiner residual encoder
    ((512, 1, 16), 1),  # decoder (transposed conv, per out-channel)
)
ACT_SHAPE = (BATCH, 1024, (SEG - 16) // 8 + 1)  # the mask conv's output, the largest activation
TIE_STEP = 2.0**-7  # ranges below are chosen so the grid step is exactly this: ties are exact
TRAIN_BATCH, TRAIN_SEG = 16, 24000  # 3 s at 16 kHz resampled by 0.5 (configs/convtasnet_2spks_8k.yaml)
TRAIN_ACT_SHAPE = (TRAIN_BATCH, 1024, (TRAIN_SEG - 16) // 8 + 1)  # the train step's largest activation
SUM_RTOL = 1e-5  # range-gradient sums against float64, relative to sum |term| (see check_sum)
TRAIN_CFG = {**MODEL_CFG, "quantization": {**MODEL_CFG["quantization"], "max_observations": 3}}
TRAIN_STEPS = 8
# Card vs CPU on one train step (phase 10). cuDNN and the CPU sum the
# convolutions in other orders, so a few pre-quantization values land on the
# other side of a rounding boundary and move by one grid step (phase 4: the
# outputs agree to about 28 dB); the loss and the gradient follow them. The
# state itself varies from run to run (cuDNN's weight-gradient sums are not
# deterministic). On an H100, two runs gave loss differences of 2.7e-3 and
# 7.5e-3 dB and gradient cosines of 0.999902 and 0.999927; the bounds leave
# more than 10x room.
LOSS_DB_TOL = 0.1
GRAD_COS_MIN = 0.999
# The int8 engine against the fake-quant forward (phase 13). The two differ where the int32 sum and
# cuDNN's float32 sum land on two sides of a rounding tie, and at full width with random weights such
# flips cascade through the 24 blocks: on an H100 the fake-quant forward itself is 27.7/28.0 dB (a mean
# of 1.74 output steps) from its own CPU run (phase 4). The engine is held to that floor as
# tests/test_serve_int8.py holds the JAX engine to the model's own eager-vs-jit agreement: SNR no more
# than 3 dB (bf16: 5 dB) below the floor's, mean |difference| at most 1.5x (bf16: 2x) the floor's.
# The absolute bounds of that test (max 10, mean 1.5 steps; bf16 mean 2) hold on the tiny model
# (tests/test_torch_int8.py), not here, where the floor alone breaks them.
INT8_FLOOR = {"float32": (3.0, 1.5), "bfloat16": (5.0, 2.0)}  # (SNR margin in dB, mean-difference factor)
# The int8 engine card vs CPU on the same weights (phase 13): (minimum SNR in dB per output, largest share
# of samples more than half an output step apart). The int8 products are exact on both devices, so only
# the float convs' sum order differs. On an H100 the float32 engine read 112.9-113.2 dB with 0.0001 of
# samples apart; on the tiny model of the CPU tests, 0.2-0.5% of samples one step apart read 52-62 dB.
# The bfloat16 engine is held to the bound that those tests hold it to against the JAX engine
# (tests/test_torch_int8.py:JAX_BOUND).
INT8_CARD_VS_CPU = {"float32": (90.0, 1e-3), "bfloat16": (40.0, 1e-2)}
EVAL_SISDR_DB = 0.5  # int8 vs fake_quant mean SI-SDR on the same weights (phase 16)
INT8_ROWS = BATCH * ((SEG - 16) // 8 + 1)  # M of the engine's 1x1 convs: 32 x 11999
# (K, N, launches per forward) of the engine's 1x1 convs: bottleneck + 24 res + 24 skip, 24 conv_in, the mask.
INT8_SHAPES = ((512, 128, 49), (128, 512, 24), (128, 1024, 1))
INT8_TIE_DELTA, INT8_TIE_MN = 2.0**-6, -2.0  # the out grid of phase 12's planted ties
# Three output grids of an attention in-projection's Q, K and V thirds (phases 22, 29): the first carries the ties.
QKV_GRIDS = ([INT8_TIE_DELTA, 0.013, 2.0**-5], [INT8_TIE_MN, -2.5, -0.25])
# The DPTNet slice (phases 17-23): configs/dptnet_2spks_8k.yaml's model_cfg, written out as MODEL_CFG is, at
# the JAX package's DPTNet serving shape (BENCH_models_r05.json): 8 x 4 s at 8 kHz.
DPTNET_CFG = {
    "name": "DPTNet",
    "model_path": None,
    "n_src": 2,
    "kernel_size": 2,
    "quantization": MODEL_CFG["quantization"],
}
# The config's own observer window (QuantSpec's default of 50 steps, which the YAML keeps). A 3-step window, as
# the ConvTasNet phases use, leaves the ranges at 73% of their initial +-0.5: the random-weight output then spans
# about 3.5 steps of its grid rms, and one-step rounding flips alone put card and CPU 18.2/20.4 dB apart
# (scripts/dptnet_noise_floor.py); with 50 steps the output spans about 32 steps.
DPT_OBSERVE_STEPS = 50
DPT_BATCH, DPT_SEG = 8, 32000
# The LSTM kernel against its plain version (phase 17). The kernel sums h @ W in k order with FMAs and adds ih
# after, as cuBLAS's float32 product and ih_t + h @ w_hh do; expf/tanhf may differ from PyTorch's by ulps.
# Differences of ~1e-7 per step stay ~1e-7 through a contracting recurrence: 1e-5 leaves 100x room, and a
# recurrence with swapped gates or an unflipped reverse direction reads ~1e-1.
LSTM_TOL = 1e-5
LSTM_ODD = (7, 3, 96)  # T, B', H: a ragged batch tile and an H the TPU kernel refuses
LSTM_PLAIN_REPS = 3  # the plain recurrences' time is the median of this many calls
# The DPTNet int8 engine card vs CPU (phase 22): its LSTMs, attention and norms are float32 sums, which flip
# rounding ties between devices as the fake-quant forward's do (phase 19), so it is held to phase 19's bound.
DPT_INT8_CARD_VS_CPU_DB = 20.0
# The Sepformer slice (phases 24-30): configs/sepformer_2spks_8k.yaml's model_cfg, at the JAX package's Sepformer
# serving shape (BENCH_models_r05.json): 8 x 4 s at 8 kHz, ranges from the config's 50-step observer window.
SEPFORMER_CFG = {
    "name": "Sepformer",
    "model_path": None,
    "n_src": 2,
    "kernel_size": 16,
    "stride": 8,
    # the ConvTasNet's quantization; the Sepformer's YAML leaves in_act_n_bits at its default (in_quant is off)
    "quantization": {k: v for k, v in MODEL_CFG["quantization"].items() if k != "in_act_n_bits"},
}
SEP_OBSERVE_STEPS = 50
SEP_BATCH, SEP_SEG = 8, 32000
# K8 against its plain version (phase 24). The kernel rounds the logits as cuBLAS does (an FMA chain in d order),
# takes P V as 3xTF32 on the tensor cores and the softmax online (the accumulator rescaled as the running max grows),
# so its float heads differ from the plain version's by float32 rounding, about 1e-6 of their largest magnitude
# (phase 24 prints it); a core with K and V swapped reads ~1, one without the max subtraction NaN. The planted rows'
# logits reach +-400, where float32's spacing (3e-5) moves a softmax weight by up to that share of itself: there
# the plain version is itself up to 2.5e-5 of max |heads| from the float64 attention on an H100 (phase 24 prints
# it), so only a kernel that rounds the logits as the plain version does stays within ATTN_REL_TOL of it. A head
# that close can still cross a rounding tie of the head grid, which moves it one step: ATTN_GRID_SHARE bounds how
# many do. Both entries (the [BH, L, d] one and the packed one on an in-projection's views) compute the same heads
# bit for bit.
ATTN_REL_TOL = 1e-5
ATTN_GRID_SHARE = 1e-3
ATTN_ODD = (3, 37, 53, 24)  # BH, Lq, Lk, d: ragged tiles on every axis, a d the TPU kernel's gate refuses
ATTN_PLANT = 100.0  # the first query of every head scaled by this: its logits overflow expf without the max
ATTN_PLAIN_REPS = 7
# The Sepformer card vs CPU (phase 26): the bound of every other model's phase (ConvTasNet 27.7/28.0 dB, DPTNet
# 25.4/27.1 dB on an H100); the float model on the same weights, whose differences are float32 sums alone.
SEP_CARD_VS_CPU_DB = 20.0
SEP_FLOAT_CARD_VS_CPU_DB = 100.0
SEP_INT8_CARD_VS_CPU_DB = 20.0  # the engine's float attention and norms flip ties as the fake-quant forward's do
# The training slice (phases 31-36): DPTNet and Sepformer KD training through the configs' model_cfg at their own
# batch of 1 (DPTNet 3 s, the Sepformer 4 s, 8 kHz), the observer window cut to 3 steps as phase 9's.
DPT_TRAIN_SEG, SEP_TRAIN_SEG = 3 * SR, 4 * SR
TRAIN_MODELS_WINDOW = 3
RECIPE_SECONDS = 1.0  # the mini LibriMix of phase 36: 2 training and 1 validation mixtures of this length
# K5 against its plain version (phase 31). The kernel takes each product as 3xTF32 on the tensor cores, summing
# each 32-step stage from zero and the stages with IEEE adds, cuBLAS in float32 in its own order: the float
# pre-activations, dx, dw and db agree within DENSE_RTOL of the sum of their terms' magnitudes (the rounding of a
# K-term float32 sum grows as sqrt(K) ulps of it, ~2e-6 at K = 1024; the kernel read 5.8e-7 on positive terms at
# K = 1024 on an H100, one TF32 product alone ~1e-3), the act ranges' gradients within SUM_RTOL of sum |term|
# (phase 8's rule). On the act grid each output is the kernel's own
# pre-activation put through K1's plain grid exactly, at most a step from the plain version's, and at most
# DENSE_GRID_SHARE of them a step apart (a pre-activation within a rounding error of a half step); the planted
# ties are exact sums and round alike. The backward is compared at the kernel's own pre-activation (the same act
# mask); the plain version's own flips at most DENSE_GRID_SHARE of the masks.
DENSE_RTOL = 1e-5
DENSE_GRID_SHARE = 1e-3
# M, K, N: ragged tiles on every axis; rows of 3, 37 and 1030 floats (not 16-byte aligned); K > 1024
DENSE_ODD = ((5, 3, 2), (1, 256, 512), (77, 64, 128), (1000, 1024, 256), (300, 37, 65), (1000, 1030, 200))
# Which grids are on, and the observing flags (phase 31): every combination the layers produce.
DENSE_FLAGS = (dict(w=True, a=True), dict(w=False, a=True), dict(w=True, a=False), dict(w=False, a=False),
               dict(w=True, a=True, w_obs=True), dict(w=True, a=True, a_obs=True),
               dict(w=True, a=True, w_obs=False, a_obs=False))
# The K7/K6 wrapper's backward against the plain recurrence's gradient (phase 32): the same plain recurrence
# differentiated at the same saved inputs, so equal up to cuBLAS picking another algorithm between the calls.
LSTM_GRAD_TOL = 1e-6  # relative to the gradient's largest magnitude
# Card vs CPU on one post-window KD step (phase 34), (|loss difference| in dB, minimum whole-gradient cosine):
# phase 10's bounds for the float versions, whose differences are float32 sums alone, and for the quantized
# models, whose tie flips phase 10's ConvTasNet met with 10x room.
TRAIN_CARD_VS_CPU = {"float": (LOSS_DB_TOL, GRAD_COS_MIN), "quantized": (LOSS_DB_TOL, GRAD_COS_MIN)}
# Phase 34's DPTNet is cut to the first DPT_CPU_LAYERS of phase 33's dual-path layers: its CPU step at all 6 took
# 30 s, the largest CPU run of the script.
DPT_CPU_LAYERS = 2
# The K3 slice (phases 37-39). K3 against its plain version (phase 37) with K5's rules (DENSE_RTOL,
# DENSE_GRID_SHARE: the same kernel, 3xTF32 on the tensor cores), at the shapes that phases 18 and 25 gave it and
# at odd ones (B, K, T, N): ragged tiles on every axis, rows of 37, 301, 1030 and 203 floats (not 16-byte
# aligned), a width that takes 64-row tiles, one column, K > 1024.
QMM_ODD = ((3, 37, 301, 65), (1, 5, 7, 3), (2, 256, 1, 64), (2, 64, 1000, 64), (2, 1030, 203, 96))
# Streaming (phase 38): a 20 s mixture in pushes of 200 ms at 8 kHz through windows of the configs' 16000-sample
# segments; the drained stream against ola_infer(chunk_batch=1) on the card: the same forward on the same windows,
# the overlap-add sums in another order (tests/test_streaming.py's bound).
STREAM_SECONDS, STREAM_SEGMENT, STREAM_PUSH, STREAM_TOL = 20, 16000, 1600, 1e-5
# The bf16 slice (phases 40-43): QuantSpec.compute_dtype "bfloat16" on the three models' serving path, with the
# phases' models' weights and ranges. Card vs CPU is held to every other model phase's bound. K5's and K3's bf16
# routes are held to their plain versions by phases 31 and 37's rules, the sums of the terms' magnitudes taken over
# the operands rounded to bf16 (the planted ties stay exact: their operands are bf16 values).
BF16_SPEC = dataclasses.replace(SPEC, compute_dtype="bfloat16")
BF16_CARD_VS_CPU_DB = 20.0
# K8's bf16 route against its plain version (phase 43). Both round the softmax weight p = exp(s - max) / sum to bf16
# after it is normalised, each with the sum taken in float64 and rounded once; where the two float64 sums round
# apart, or exp differs by an ulp, a weight within that of a bf16 tie goes to the other neighbour (about 2^-14 of
# such weights), and its head moves by up to one bf16 step (2^-7 p) of p |v|. Every row is held within ATTN_REL_TOL
# of max |heads|, except rows where the plain version shows a weight within ATTN_BF16_TIE_ULPS float32 ulps of a bf16
# tie (ops/attention.py:bf16_tie_mask): those are held within ATTN_REL_TOL of max |heads| plus 2^-7 p |v| summed over
# such weights. The f32 rule (phase 24) is unchanged. The phase prints those rows' count and share.
ATTN_BF16_TIE_ULPS = 2
# The music slice (phases 44-53): configs/convtasnet_music.yaml's model_cfg, written out as MODEL_CFG is: the
# full-width ConvTasNet-music (256 filters, bottleneck 256, hidden 512, 4 repeats x 10 blocks, 4 stems, stereo).
MUSIC_CFG = {
    "name": "ConvTasNetMusic",
    "model_path": None,
    "sources": ["drums", "bass", "other", "vocals"],
    "audio_channels": 2,
    "kernel_size": 20,
    "stride": 10,
    "quantization": {
        "qat": True, "gradient_based": True, "weight_quant": True, "weight_n_bits": 8,
        "act_quant": True, "act_n_bits": 8, "in_quant": False, "out_quant": True, "out_act_n_bits": 8,
        "n_splitter": 2, "n_combiner": 2, "observer": True,
    },
}
MUSIC_SR = 44100
# The serving forward: one OLA batch of a track as the config's testing_cfg gives it, 8 chunks of 441,000 samples.
MUSIC_BATCH, MUSIC_SEG = 8, 441000
MUSIC_OBSERVE = (2, 2 * MUSIC_SR, 50)  # ranges: the config's 50-step observer window over 2 x 2 s of stems
MUSIC_CPU_SEG = 2 * MUSIC_SR  # the int8 engines' card-vs-CPU input, 1 x 2 s (the CPU's float64 int8 products)
# Card vs CPU (phase 45). At full depth with random weights the 40 blocks amplify a difference in the last bit of any
# activation until most outputs sit a grid step or more apart: on an H100 the card's forward of one chunk against
# its own forward of that chunk times (1 + 2^-22) read 17.90-18.34 dB, card vs CPU 18.08-18.55 dB, every layer's
# card-vs-CPU distance no larger than the card's own (85 against 64 dB at the encoder, growing apart by about 4 dB a
# block over the first blocks; scripts/music_noise_floor.py, PERF.md section 6). No float32 implementation meets 20 dB
# there, so the full-depth forward is held to that own floor, measured in the same run, by phase 13's rule (SNR at
# most 3 dB below the floor's, mean |difference| at most 1.5x the floor's); the 20 dB bound of every other model's
# phase holds where the floor allows it, at the same width with one repeat (10 blocks; about 26 dB there). The CPU
# runs card vs CPU at that depth alone (phases 45 and 47): its full-depth forwards were the longest CPU work of the
# run, and at full depth the card's own floor is what phase 47 holds the int8 engines to.
MUSIC_PERTURB = 2.0**-22
MUSIC_FLOOR_RULE = INT8_FLOOR["float32"]
MUSIC_SHALLOW = {"n_repeats": 1, "n_blocks": 5}  # the card-vs-CPU depth of phases 45 and 47 (5 of 40 blocks)
MUSIC_THROUGHPUT_REPS = 1  # phase 48: one timed forward of each engine (≈ 2 s) after its warm-up
# The int8 engines card vs CPU (phase 47) at 1 x 2 s. Phase 13's bounds (INT8_CARD_VS_CPU: the int8 products are exact
# on both devices) hold for the tiny music model of tests/test_torch_cuda.py, not at this width: on an H100 the
# float32 engine read 55.3 dB at one block, 47.1 at 3, 37.9 at 6, 27.7 at 10, 22.4 at 20 and 18.7 at 40 (the float
# encoder, norms and depthwise convs flip requantization ties, and the blocks amplify the flips as they do the
# fake-quant forward's; scripts/music_noise_floor.py), and its own forward of the input times (1 + 2^-22) read 17.9 dB
# from it at 40 (phase 47). So the engine is held to its own floor by MUSIC_FLOOR_RULE, at MUSIC_SHALLOW's depth.
# Card vs CPU on one post-window KD step (phase 52), the same rule: the L1 losses within LOSS_DB_TOL dB, and 1 - the
# whole-gradient cosine at most MUSIC_FLOOR_RULE[1] times the card's own (its step on the stems times (1 + 2^-22)).
# On an H100 card vs CPU read 0.998740 and the card's own 0.998815 at full depth; GRAD_COS_MIN (phase 10's bound)
# does not hold at this width: a model of one repeat four steps after its window read 0.9910 card vs CPU.
EVAL_NSDR_DB = 0.5  # int8 vs fake_quant mean NSDR on the same weights (phase 50)
# KD training (phases 51-52): the config's 6 s windows, shifted by its 8192-sample augmentation, at the largest of
# the config's batch of 4, then 2 and 1, whose batch-1 peak says it fits in MUSIC_TRAIN_MEMORY of the card; the
# observer window cut to 3 steps (phase 9's) so that the later steps train the ranges.
MUSIC_TRAIN_SEG, MUSIC_TRAIN_WINDOW, MUSIC_TRAIN_MEMORY = 6 * MUSIC_SR, 3, 0.9
MUSIC_AUGMENT = {"enable": True, "shift": 8192, "flip": True, "scale": True, "remix_group_size": 0}
MUSIC_RECIPE_SECONDS = 2.0  # the mini MUSDB of phase 53: 2 training tracks and 1 test track of this length
# The HTDemucs slice (phases 54-60): configs/htdemucs.yaml's model_cfg, written out as MODEL_CFG is, with the JAX
# factory's defaults for every key it leaves out: channels 48, growth 2, depth 4, nfft 4096, 5 transformer layers of 8
# heads (d 48), hidden scale 4, segment 10 s at 44.1 kHz.
HTDEMUCS_CFG = {"name": "HTDemucs", "model_path": None, "sources": MUSIC_CFG["sources"], "audio_channels": 2,
                "quantization": MUSIC_CFG["quantization"]}
# The serving forward: one OLA batch as val gives it, 8 chunks of testing_cfg.segment_samples, which train=False pads
# to the 441,000-sample training segment: 431 frames of 2048 bins, 8 x 431 = 3,448 frequency tokens and 1,723 time
# tokens at E 384 in the transformer.
HTD_SR, HTD_BATCH, HTD_SEG = 44100, 8, 343980
HTD_OBSERVE = (2, 2 * HTD_SR, 50)  # ranges: the config's 50-step observer window over 2 x 2 s of stems (train=True)
# Card vs CPU (phase 55) on one chunk: >= 20 dB where the floor allows, at HTD_SHALLOW (the same width with one
# transformer layer); the int8 engines card vs CPU there within their own floor (phase 57, MUSIC_FLOOR_RULE). At full
# depth the card's own floor (its forward of the input times 1 + 2^-22) is what phase 57 holds the int8 engines to
# against the fake-quant forward; the full-depth CPU forwards are left out as the music ones are.
HTD_SHALLOW = {"t_layers": 1}
# The gelu routes against their plain versions (phase 59): |gelu(a) - gelu(b)| <= 1.13 |a - b| (the largest slope of
# the exact GELU, 1.1289), so K5's GELU route is held to phase 31's DENSE_RTOL of its pre-GELU bound times this.
GELU_SLOPE = 1.13
# The HTDemucs training slice (phases 61-64): configs/htdemucs.yaml's 7.8 s windows (dataset_cfg.segment) after its
# 8192-sample shift, with its flips, gains and remix groups of 4; the solver's exp loss with the recipe's source
# weights (uniform: the config lists none), its batch EMA (ema_batch 0.9995), lr 3e-4 and no clip (optim.clip_grad
# 0); the observer window cut to MUSIC_TRAIN_WINDOW steps (phase 9's) so that the later steps train the ranges; its
# batch of 32 cut to the largest of 4, 2, 1 whose batch-1 peak says it fits in MUSIC_TRAIN_MEMORY of the card.
HTD_TRAIN_SEG = int(7.8 * HTD_SR)
HTD_AUGMENT = {"enable": True, "shift": 8192, "flip": True, "scale": True, "remix_group_size": 4}
HTD_EMA = (0.9995,)
# Card vs CPU on one post-window htdemucs step (phase 63): the L1 losses within LOSS_DB_TOL dB, and 1 - the
# whole-gradient cosine at most MUSIC_FLOOR_RULE[1] times the sum of the card's own and the CPU's own (each device's
# step on the stems times (1 + 2^-22)). Phase 52's floor, the card's own alone, does not bound it here: on an H100
# (700 W) three runs of this phase read card vs CPU 2.6e-5-3.2e-5 against the card's own 1.2e-5-1.7e-5 (1.6-2.2x)
# and, in two of them, the CPU's own 1.1e-5-1.5e-5; scripts/htdemucs_step_floor.py read 7.3e-6 against 6.1e-6 and
# 3.4e-6, the three distances spread over the same parameters (the time branch's outer layers lead in each; two card
# runs agree to 1e-12). Card vs CPU is the two devices' own noise added, not a fault of either. A second check whose
# rule did not move: the step at HTD_STEP_SHALLOW (one transformer layer, two encoder levels) after four steps at
# 1 x 1 s (the MUSIC_TRAIN_WINDOW-step window and one more), against the card's own floor alone by phase 52's rule.
# On an H100 (700 W) three runs read card vs CPU 1 - cos 9.3e-6-1.18e-5 against the card's own 1.6e-6-3.0e-6
# (3.8-6.1x) and, in the last two, 2.1-2.9x the card's and the CPU's own floors added: at this depth the devices' own
# floors shrink (less of the perturbation is amplified) and card vs CPU does not, so the rule fails; the phase reports
# its verdict, the CPU's own floor and the ratio to the two floors' sum.
HTD_STEP_SHALLOW = {"t_layers": 1, "depth": 2}
HTD_RECIPE_SECONDS = 2.0  # the mini MUSDB of phase 64: 2 training tracks (one of them validation) and 1 test track
# The H100 SXM's published peaks (NVIDIA's data sheet): device memory, dense int8, float32, TF32 and bf16 rates.
HBM_BYTES_S, INT8_OPS_S, F32_OPS_S, TF32_OPS_S, BF16_OPS_S = 3.35e12, 1.979e15, 67e12, 495e12, 989e12
# The route K5, K5-bwd and K3 take: three TF32 tensor-core products for each float32 one.
# The quantizer variants (phases 69-71): the flagship with the mu-law I/O grids and the MSE quantizer, its window cut
# to 3 steps as phase 9's, at the train step of phase 11 (16 x 3 s); DPTNet with the trained residual decoder of its
# Linear decoder and the MSE quantizer, at phase 33's batch of 1 x 3 s.
VARIANT_CFG = {**TRAIN_CFG, "quantization": {**TRAIN_CFG["quantization"], "in_quant": True, "inout_nl_quant": True,
                                             "act_quantizer": "mse", "max_observations": 3}}
VARIANT_STEPS = (3, 5)  # KD steps inside the window, then after the calibration
VARIANT_KEYS = ("in_quant", "inout_nl_quant", "act_quantizer", "max_observations")
RES_DEC_CFG = {**DPTNET_CFG, "quantization": {**DPTNET_CFG["quantization"], "train_res_dec": True,
                                              "act_quantizer": "mse", "max_observations": 3}}
RES_DEC_STEPS = (3, 1)
RES_DEC_WEIGHT_QUANTIZERS = 93  # DPTNet's 92 and the residual decoder's
# The MSE observer card vs CPU (phase 69): five activations of the flagship's bottleneck width at the train step's
# batch. The bin counts and the window are exact on both devices; the re-binned histogram is a float32 CDF
# interpolation, which a device may sum or contract otherwise: its L1 distance within MSE_HIST_L1 of the count.
MSE_OBSERVE_SHAPE = (TRAIN_BATCH, 128, (TRAIN_SEG - 16) // 8 + 1)
MSE_HIST_L1 = 1e-5
# The mu-law quantizer on the card against its plain version on the CPU (phase 69): the compress and expand steps
# are log1p and pow of each device, which may differ by ulps; where that moves a value across a rounding tie of the
# inner grid it moves one code, as on every act grid (DENSE_GRID_SHARE of them at most).
MULAW_REL_TOL = 1e-5
# The LSTM modes (phases 72-74): configs/dptnet_2spks_8k.yaml's model with quantization.lstm_mode set.
STATIC_CFG = {**DPTNET_CFG, "quantization": {**DPTNET_CFG["quantization"], "lstm_mode": "static"}}
DYNAMIC_CFG = {**DPTNET_CFG, "quantization": {**DPTNET_CFG["quantization"], "lstm_mode": "dynamic"}}
# The static route against its plain version (phase 72; tests/test_torch_cuda.py): the route and the plain version
# take the same grids, but the product's sums and PyTorch's transcendentals differ by ulps (phase 17), which move a
# value across a rounding tie of a site now and then, and the step carries on through the recurrence. Every output
# within one step of the output site's grid, at most STATIC_SHARE of them more than half a step apart (the layer
# rule); the ranges after the window, EMAs of the float cell's extremes, within STATIC_RANGE_REL of each width.
STATIC_SHARE = 0.01
STATIC_RANGE_REL = 1e-6
STATIC_WINDOW = 5  # a call that starts 5 steps before the observer window closes (site_n_iter 45)
# The static cell's 21 quantizations a row and unit a step (ih, hh and add0 on 4 gates, the 4 gates, mul0, mul1,
# add1, tanh1, mul2), each subtract, divide, round, two clips, multiply and add: the route's bound counts them
# beside the product's 8H + 4 operations.
STATIC_SITE_OPS = 21 * 7
STATIC_PLAIN_REPS = 1  # the plain static recurrence (~150 launches a step; 0.7-0.9 s a call) timed once
# Phase 73's KD step crosses every LSTM's window (serving then runs on closed ones) at one dual-path layer: its
# backward recomputes the plain static cell, ~300 launches a step and direction (21 s a step at 2 layers).
STATIC_TRAIN_STEPS = 1
STATIC_CPU_SEG = SR // 2  # phase 73's card vs CPU input, 0.5 s (1 s before: the phase took 19.8-66.5 s)
STATIC_TRAIN_LAYERS = 1
DYNAMIC_TRAIN_LAYERS = 1  # the dynamic step: the plain loop forward and backward (26 s at 2 layers)
# Phase 74's card vs CPU at the first DYNAMIC_CPU_LAYERS dual-path layers: the CPU's plain dynamic loop at all 6 took
# ~40 s of the run (the card's own forward at 8 x 4 s runs all 6); 2 layers until the parallel phases' growth.
DYNAMIC_CPU_LAYERS = 1
# Phase 34's Sepformer at its first block (of 2): its CPU step at full depth took 24 s.
SEP_CPU_CUT = {"n_repeats": 1}
DENSE_ROUTE = "tensor cores: 3xTF32 mma.sync m16n8k8, 3-stage cp.async ring"
# The routes of K7/K6 and K4.
LSTM_ROUTE = ("CUDA cores, float32 FMA: thread-block clusters, each CTA's W_hh slice resident in shared memory, h "
              "exchanged through distributed shared memory (blocks reading W_hh from L2 for H above 322)")
ATTN_ROUTE = ("Q K^T on the CUDA cores (float32 FMA in d order, cuBLAS's rounding), P V on the tensor cores (3xTF32 "
              "mma.sync m16n8k8) under an online softmax, 3-stage cp.async K/V ring, heads read from and written to "
              "the in-projection's layout")
GROUP_ROUTE = ("CUDA cores: all of a model's weight quantizers in one launch from a device-resident table, a warp, "
               "a thread or a block a channel; the one-shot observer and where(observing, w, y) inside")
BF16_DENSE_ROUTE = ("tensor cores: one TF32 mma.sync m16n8k8 a product of the operands rounded to bf16 as they leave "
                    "shared memory (exact in TF32), each 32-step stage summed from zero, 3-stage cp.async ring")
BF16_ATTN_ROUTE = ("three passes over the key tiles through the 3-stage cp.async ring, each tile rounded to bf16 in "
                   "shared memory: the rows' max, their sums of exp(s - max) in float64, then P = exp(s - max) / sum "
                   "rounded to bf16; Q K^T a float32 FMA chain of exact products on the CUDA cores, P V one TF32 "
                   "mma.sync a product")
INT8_ROUTE = ("tensor cores: s8 mma.sync m16n8k32, persistent blocks with the weight tile resident in shared memory, "
              "3-stage cp.async ring, output tiles staged and stored as 16-byte rows")


def log(msg: str) -> None:
    print(msg, flush=True)


_STANDING: list[str] = []  # the checks whose rule fails and stands (ROADMAP.md queue 3), repeated before the result


def standing(msg: str) -> None:
    """Log a check whose rule fails where the failure stands (ROADMAP.md queue 3): the run goes on, and the line is
    repeated before the result."""
    _STANDING.append(msg)
    log(f"[standing failure] {msg}")


_CLOCK = {"start": time.perf_counter(), "last": time.perf_counter()}


def clock(phases: str) -> None:
    """Log the seconds of the phases just run and of the run so far."""
    now = time.perf_counter()
    log(f"[time] phases {phases}: {now - _CLOCK['last']:.1f} s; {now - _CLOCK['start']:.1f} s since the start")
    _CLOCK["last"] = now


def side_by_side(*calls) -> None:
    """Run ``calls``, phases that each wait on a process of their own, in threads at once; a failure propagates."""
    with concurrent.futures.ThreadPoolExecutor(len(calls)) as pool:
        for future in [pool.submit(call) for call in calls]:
            future.result()


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds of ``fn()`` over n calls, by CUDA events, after a warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def median_ms(fn, n: int) -> tuple[float, float, float]:
    """Median, least and most milliseconds of n calls of ``fn()``, each timed by its own CUDA events, after a
    warm-up: for a call long enough (tens of ms) that its time varies with the host between readings."""
    fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), min(times), max(times)


def bound_of(bytes_moved: float, ops: float, ops_per_s: float) -> dict:
    """The least time the card could take: bytes over the memory rate or operations over the peak, the larger."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S * 1e3, ops / ops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def route_bound(bytes_moved: float, ops: float) -> dict:
    """The least time of K5, K5-bwd and K3's route: 3 TF32 products for each float32 one at the TF32 peak, or the
    bytes over the memory rate, the larger."""
    b = bound_of(bytes_moved, 3 * ops, TF32_OPS_S)
    return {"route_bound_ms": b["bound_ms"], "route_bound_by": b["bound_by"]}


def dense_kernel_report(build_log: str) -> None:
    """Phase 1: ptxas's registers and spill stores of each qat_dense_kernel instantiation (tile rows, columns,
    operand layouts, epilogue); raises if one spills."""
    epilogues = ("forward", "mask", "dx", "dwq")
    lines = build_log.splitlines()
    spilled = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '.*qat_dense_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)ELi(\d)ELb(\d)E",
                      line)
        if m is None:
            continue
        spill = int(re.search(r"(\d+) bytes spill stores", lines[i + 2]).group(1))
        regs = int(re.search(r"Used (\d+) registers", lines[i + 3]).group(1))
        bi, bj, a_rc, b_rc, epi, bf16 = (int(v) for v in m.groups())
        log_line = (f"[1] qat_dense_kernel {bi} x {bj}, A {'K' if a_rc else 'MN'}-major, B {'K' if b_rc else 'MN'}-"
                    f"major, {epilogues[epi]}{' (bf16 route)' if bf16 else ''}: {regs} registers, {spill} bytes spill "
                    f"stores")
        log(log_line)
        if spill:
            spilled.append(log_line)
    if spilled:
        raise AssertionError(f"qat_dense_kernel instantiations spill: {spilled}")


def attention_kernel_report(build_log: str) -> None:
    """Phase 1: ptxas's registers and spill stores of each K8 instantiation (the head width it pads d to, the rows
    of a warp); raises if one of the main path's (d 16 and 32, and HTDemucs's 48 on the D 64 instantiations)
    spills."""
    lines = build_log.splitlines()
    spilled = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '.*attention_kernelILi(\d+)ELi(\d+)ELb(\d)EE", line)
        if m is None:
            continue
        spill = int(re.search(r"(\d+) bytes spill stores", lines[i + 2]).group(1))
        regs = int(re.search(r"Used (\d+) registers", lines[i + 3]).group(1))
        dim, mt, bf16 = int(m.group(1)), int(m.group(2)), int(m.group(3))
        log_line = (f"[1] attention_kernel{' (bf16 route)' if bf16 else ''} d <= {dim}, {16 * mt} rows a warp "
                    f"({k8.max_warps(dim, mt)} warps a block at most): {regs} registers, {spill} bytes spill stores")
        log(log_line)
        if spill and dim <= 64:
            spilled.append(log_line)
    if spilled:
        raise AssertionError(f"attention_kernel instantiations of the main path spill: {spilled}")


LSTM_MODES = {v: k for k, v in {"fused (K7/K6)": 0, "static route, observing window": 1,
                                 "static route, quantized": 2}.items()}


def lstm_int8_kernel_report(build_log: str) -> None:
    """Phase 1: ptxas's registers and spill stores of each LSTM (K7/K6) and int8 (K4) kernel instantiation, with
    the shared memory of the main path's launches; raises if one spills."""
    lines = build_log.splitlines()
    spilled = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '.*?(lstm_cluster_kernel|lstm_blocks_kernel|int8_mm_requant_kernel)I"
                      r"([^']*?)EEEv", line)
        if m is None:
            continue
        spill = int(re.search(r"(\d+) bytes spill stores", lines[i + 2]).group(1))
        regs = int(re.search(r"Used (\d+) registers", lines[i + 3]).group(1))
        args = [int(v) for v in re.findall(r"L[bi](\d+)E?", m.group(2))]
        if m.group(1) == "lstm_cluster_kernel":
            what = (f"lstm_cluster_kernel {LSTM_MODES[args[2]]}, {8 * args[0]}-row tile, "
                    f"{'float4' if args[1] else 'scalar'} h; shared memory at H 128, cluster 2: "
                    f"{lk.cluster_smem(128, 2, 8 * args[0], args[2] == lk.MODES['static'])} B")
        elif m.group(1) == "lstm_blocks_kernel":
            what = f"lstm_blocks_kernel {LSTM_MODES[args[1]]}, {'float4' if args[0] else 'scalar'} h (H > 322)"
        else:
            bn = 16 * args[2]
            what = (f"int8_mm_requant_kernel {'cp.async' if args[0] else 'byte'} loads, {im.NLS[args[1]]}, N tile {bn}, "
                    f"{args[3]} block(s) an SM; shared memory at K 128 / 512: {im.smem_bytes(bn, 128)} / "
                    f"{im.smem_bytes(bn, 512)} B")
        log_line = f"[1] {what}: {regs} registers, {spill} bytes spill stores"
        log(log_line)
        if spill:
            spilled.append(log_line)
    if spilled:
        raise AssertionError(f"LSTM or int8 kernel instantiations spill: {spilled}")


def compare(name: str, kernel_out: torch.Tensor, plain_out: torch.Tensor) -> float:
    torch.cuda.synchronize()
    err = (kernel_out - plain_out).abs().max().item() if kernel_out.numel() else 0.0
    if not torch.equal(kernel_out, plain_out):
        raise AssertionError(f"{name}: kernel and plain version differ (max abs err {err})")
    return err


def tie_values(n: int, device) -> torch.Tensor:
    """Half-step ties k + 0.5 for k in [-131, 131) on a grid of step TIE_STEP."""
    k = torch.arange(n, device=device) % 262 - 131
    return (k + 0.5) * TIE_STEP


def check_act_kernel(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    results = {"max_abs_err": 0.0}
    # The main path's largest activation, with an arbitrary range and values
    # planted exactly at the range ends.
    x = torch.randn(ACT_SHAPE, device=dev, generator=g) * 1.5
    mn = torch.tensor([-1.7], device=dev)
    mx = torch.tensor([2.3], device=dev)
    x.view(-1)[:4] = torch.tensor([-1.7, 2.3, -5.0, 5.0], device=dev)
    y = fq.act_fake_quant(x, mn, mx, 8)
    results["max_abs_err"] = max(results["max_abs_err"], compare(f"act {ACT_SHAPE}", y, fq.act_fake_quant_ref(x, mn, mx, 8)))
    results["ms"] = cuda_ms(lambda: fq.act_fake_quant(x, mn, mx, 8), 20)
    results["plain_ms"] = cuda_ms(lambda: fq.act_fake_quant_ref(x, mn, mx, 8), 5)
    results.update(bound_of(8 * x.numel(), 7 * x.numel(), F32_OPS_S))  # x in, y out; sub, div, round, 2 clips, mul, add
    gb = 2 * x.numel() * 4 / 1e9
    log(f"[2] act_fake_quant {tuple(x.shape)}: bitwise equal; kernel {results['ms']:.3f} ms "
        f"({gb / results['ms'] * 1e3:.0f} GB/s of {gb:.2f} GB moved), plain {results['plain_ms']:.3f} ms")
    del x, y
    # Odd sizes, with exact ties: mn = -1 and mx = -1 + 255 * TIE_STEP make the step exactly TIE_STEP.
    mn = torch.tensor([-1.0], device=dev)
    mx = torch.tensor([-1.0 + 255 * TIE_STEP], device=dev)
    for n in (1, 1023, 1025, 1 << 20):
        x = mn + tie_values(n, dev)
        x[: n // 2] = torch.rand(n // 2, device=dev, generator=g) * 2.4 - 1.2
        for entry in (fq.act_fake_quant, fq.fake_quant):
            err = compare(f"{entry.__name__} n={n}", entry(x, mn, mx, 8), fq.act_fake_quant_ref(x, mn, mx, 8))
            results["max_abs_err"] = max(results["max_abs_err"], err)
    log("[2] act_fake_quant and fake_quant at 1, 1023, 1025 and 2^20 elements with planted ties: bitwise equal")
    return results


def check_weight_kernel(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(1)
    results = {"max_abs_err": 0.0}
    for shape, ch_axis in WEIGHT_SHAPES:
        w = (torch.rand(shape, device=dev, generator=g) * 2 - 1) * 0.3
        reduce = tuple(i for i in range(w.ndim) if i != ch_axis)
        mn, mx = w.amin(reduce, keepdim=True), w.amax(reduce, keepdim=True)
        # channel 0: a range whose step is exactly TIE_STEP, and tie values across it
        mn.view(-1)[0], mx.view(-1)[0] = -255 / 256, 255 / 256
        first = w.select(ch_axis, 0)
        first.copy_(tie_values(first.numel(), dev).reshape(first.shape))
        y = fq.weight_fake_quant(w, mn, mx, 8, ch_axis)
        err = compare(f"weight {shape} axis {ch_axis}", y, fq.weight_fake_quant_ref(w, mn, mx, 8, ch_axis))
        results["max_abs_err"] = max(results["max_abs_err"], err)
        ms = cuda_ms(lambda: fq.weight_fake_quant(w, mn, mx, 8, ch_axis), 200)
        plain_ms = cuda_ms(lambda: fq.weight_fake_quant_ref(w, mn, mx, 8, ch_axis), 200)
        log(f"[2] weight_fake_quant {shape} ch_axis={ch_axis}: bitwise equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if shape == (1024, 128, 1):
            results["ms"], results["plain_ms"] = ms, plain_ms
            # w in, y out, two ranges of 1024; per element div, round, 2 clips, mul (+ the step per channel)
            results.update(bound_of(8 * w.numel() + 8 * shape[0], 5 * w.numel(), F32_OPS_S))
    return results


def check_sum(name: str, got: torch.Tensor, exact: torch.Tensor, bound: torch.Tensor) -> float:
    """A kernel's float32 sum against the float64 sum of the same float32 terms.

    ``bound`` is the float64 sum of the terms' magnitudes (0 where the result
    must be exactly 0). The kernel adds in another order than the float64
    sum: within a thread, then a warp, a block and across blocks, at most
    about 70 additions deep at these sizes, so its error stays below
    SUM_RTOL = 1e-5 of the magnitudes' sum (70 x 2^-24 = 4.2e-6)."""
    err = (got.double().reshape(exact.shape) - exact).abs()
    if bool((err > SUM_RTOL * bound).any()):
        worst = (err / bound.clamp_min(1e-300)).max().item()
        raise AssertionError(f"{name}: sum off by {worst:.3g} of sum |term| > {SUM_RTOL}")
    return err.max().item()


def check_act_bwd_kernel(dev) -> dict:
    """K1-bwd against its plain version at the train step's largest activation and odd sizes."""
    g_ = torch.Generator(device=dev).manual_seed(3)
    results = {"max_abs_err": 0.0}

    def check(name, x, g, mn, mx, s):
        dx, dmn, dmx = fq.act_fake_quant_bwd(x, g, mn, mx, 8, s)
        ref_dx, p_mn, p_mx = fq.act_bwd_terms(x, g, mn, mx, 8, s)
        err = compare(f"{name} dx", dx, ref_dx)
        for got, terms in ((dmn, p_mn), (dmx, p_mx)):
            err = max(err, check_sum(f"{name} range grad", got, terms.double().sum(), terms.double().abs().sum()))
        results["max_abs_err"] = max(results["max_abs_err"], err)

    x = torch.randn(TRAIN_ACT_SHAPE, device=dev, generator=g_) * 1.5
    g = torch.randn(TRAIN_ACT_SHAPE, device=dev, generator=g_)
    mn, mx = torch.tensor([-1.7], device=dev), torch.tensor([2.3], device=dev)
    x.view(-1)[:4] = torch.tensor([-1.7, 2.3, -5.0, 5.0], device=dev)
    for s in (1.0, fq.act_scale(x, 8, True)):
        check(f"act bwd {TRAIN_ACT_SHAPE} s={s:.4g}", x, g, mn, mx, s)
    results["ms"] = cuda_ms(lambda: fq.act_fake_quant_bwd(x, g, mn, mx, 8, 1.0), 20)
    results["plain_ms"] = cuda_ms(lambda: fq.act_fake_quant_bwd_ref(x, g, mn, mx, 8, 1.0), 5)
    results.update(bound_of(12 * x.numel(), 15 * x.numel(), F32_OPS_S))  # x, g in; dx out; mask, dx and two terms
    gb = 3 * x.numel() * 4 / 1e9
    log(f"[8] act_fake_quant_bwd {TRAIN_ACT_SHAPE}: dx bitwise equal, sums within {SUM_RTOL} of sum |term|; "
        f"kernel {results['ms']:.3f} ms ({gb / results['ms'] * 1e3:.0f} GB/s of {gb:.2f} GB moved), "
        f"plain {results['plain_ms']:.3f} ms")
    del x, g
    mn = torch.tensor([-1.0], device=dev)
    mx = torch.tensor([-1.0 + 255 * TIE_STEP], device=dev)
    for n in (1, 1023, 1025, 1 << 20):
        x = mn + tie_values(n, dev)  # ties at every half step, across and beyond both clip bounds
        x[: n // 2] = torch.rand(n // 2, device=dev, generator=g_) * 2.4 - 1.2
        check(f"act bwd n={n}", x.reshape(1, n), torch.randn(1, n, device=dev, generator=g_), mn, mx, 1.0)
    log("[8] act_fake_quant_bwd at 1, 1023, 1025 and 2^20 elements with planted ties: dx bitwise equal, sums "
        "within tolerance")
    return results


def check_weight_bwd_kernel(dev) -> dict:
    """K2-bwd against its plain version at the 7 weight shapes, on channel axes 0 and 1."""
    g_ = torch.Generator(device=dev).manual_seed(4)
    results = {"max_abs_err": 0.0}
    for shape, _ in WEIGHT_SHAPES:
        for ch_axis in (0, 1):
            w = (torch.rand(shape, device=dev, generator=g_) * 2 - 1) * 0.3
            g = torch.randn(shape, device=dev, generator=g_)
            dims = tuple(i for i in range(w.ndim) if i != ch_axis)
            mn, mx = w.amin(dims, keepdim=True), w.amax(dims, keepdim=True)
            mx.view(-1)[1::3] = -mn.view(-1)[1::3]  # |mn| == |mx|: the range gradient splits 0.5/0.5
            mn.view(-1)[0], mx.view(-1)[0] = -255 / 256, 255 / 256
            first = w.select(ch_axis, 0)
            first.copy_(tie_values(first.numel(), dev).reshape(first.shape))
            for s in (1.0, fq.weight_scale(shape[ch_axis], 8, True)):
                dw, dmn, dmx = fq.weight_fake_quant_bwd(w, g, mn, mx, 8, s, ch_axis)
                ref_dw, terms = fq.weight_bwd_terms(w, g, mn, mx, 8, ch_axis)
                err = compare(f"weight bwd {shape} axis {ch_axis} dw", dw, ref_dw)
                exact = fq.route_range_grad(terms.double().sum(dims), mn.double(), mx.double(), 8, s)
                bound = fq.route_range_grad(terms.double().abs().sum(dims), mn.double(), mx.double(), 8, s)
                for got, want, b in zip((dmn, dmx), exact, bound):
                    err = max(err, check_sum(f"weight bwd {shape} axis {ch_axis}", got, want, b.abs()))
                results["max_abs_err"] = max(results["max_abs_err"], err)
            ms = cuda_ms(lambda: fq.weight_fake_quant_bwd(w, g, mn, mx, 8, 1.0, ch_axis), 200)
            plain_ms = cuda_ms(lambda: fq.weight_fake_quant_bwd_ref(w, g, mn, mx, 8, 1.0, ch_axis), 200)
            log(f"[8] weight_fake_quant_bwd {shape} ch_axis={ch_axis}: dw bitwise equal, range grads within "
                f"tolerance; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if (shape, ch_axis) == ((1024, 128, 1), 0):
                results["ms"], results["plain_ms"] = ms, plain_ms
                # w, g in; dw out; two ranges in, two range gradients out
                results.update(bound_of(12 * w.numel() + 16 * shape[ch_axis], 10 * w.numel(), F32_OPS_S))
    return results


def weight_group_models(dev) -> dict:
    """The five models' full-width module trees on the card (phase 3's ConvTasNet, DPTNET_CFG's, SEPFORMER_CFG's,
    MUSIC_CFG's and HTDEMUCS_CFG's), in train() mode, with seeded random weights: their weight quantizers are the
    groups of phases
    2 and 8."""
    conv = ConvTasNet(n_srcs=2, kernel_size=16, stride=8, q=dataclasses.replace(SPEC, observer=True),
                      generator=torch.Generator().manual_seed(2))
    return {"ConvTasNet": conv.to(dev),
            "DPTNet": create_model(DPTNET_CFG, generator=torch.Generator().manual_seed(2)).to(dev),
            "Sepformer": create_model(SEPFORMER_CFG, generator=torch.Generator().manual_seed(2)).to(dev),
            "ConvTasNetMusic": create_model(MUSIC_CFG, generator=torch.Generator().manual_seed(2)).to(dev),
            "HTDemucs": create_model(HTDEMUCS_CFG, generator=torch.Generator().manual_seed(2)).to(dev)}


def group_of(model) -> fq.WeightGroup:
    """``model``'s weight quantizers as one group, as its forward's weight pass builds it."""
    return fq.WeightGroup([getattr(layer, q).entry(getattr(layer, w)) for layer, q, w in weight_quantizer_sites(model)])


def weight_group_bound(group: fq.WeightGroup, backward: bool) -> dict:
    """The grouped call's bound: weights in and outputs out (backward: the gradients in too), two ranges in and two
    out per channel, a flag an entry; per element a division, a rounding, two clips and a product (backward: ten
    operations for the mask, dw and the term)."""
    per_element = 12 if backward else 8
    return bound_of(per_element * group.total + 16 * group.channels + 4 * len(group),
                    (10 if backward else 5) * group.total, F32_OPS_S)


def check_weight_groups(dev, models: dict | None = None, phase: int = 2) -> tuple[dict, dict]:
    """Phase 2: the grouped forward kernel against its plain version on the card, at each model's full weight set.

    The observing call in train() mode (outputs = the weights, the observers' written ranges and flags), then,
    with channel 0 of every weight planted with half-step ties of a 2^-7 step, the serving call in eval() mode:
    all bitwise (``torch.equal``). Returns each model's times and bound, and the groups and buffers of the second
    call for phase 8."""
    results, pairs = {}, {}
    for name, model in (models or weight_group_models(dev)).items():
        other = copy.deepcopy(model)
        gk, gp = group_of(model), group_of(other)
        buf = fq._group_forward(gk)
        ref = torch.empty_like(buf)
        fq.weight_group_forward_ref(gp, ref)
        err = compare(f"{name} grouped observing call", buf, ref)
        for i, (ek, ep) in enumerate(zip(gk.entries, gp.entries)):
            err = max(err, compare(f"{name} entry {i} observed min", ek.min_range, ep.min_range),
                      compare(f"{name} entry {i} observed max", ek.max_range, ep.max_range))
            if not (bool(ek.observed) and bool(ep.observed)):
                raise AssertionError(f"{name} entry {i}: the observer's flag is not set")
        if not torch.equal(buf[:gk.total], torch.cat([e.w.reshape(-1) for e in gk.entries])):
            raise AssertionError(f"{name}: the observing call did not return the weights")
        with torch.no_grad():
            for e in (*gk.entries, *gp.entries):
                e.min_range.view(-1)[0], e.max_range.view(-1)[0] = -255 / 256, 255 / 256
                first = e.w.select(e.ch_axis, 0)
                first.copy_(tie_values(first.numel(), dev).reshape(first.shape))
        gk, gp = group_of(model.eval()), group_of(other.eval())
        buf = fq._group_forward(gk)
        ref = torch.empty_like(buf)
        fq.weight_group_forward_ref(gp, ref)
        err = max(err, compare(f"{name} grouped call", buf, ref))
        ms = cuda_ms(fq.group_kernel_call(gk), 200)  # the kernel alone: its arguments built beforehand
        call_ms = cuda_ms(lambda: fq._group_forward(gk), 200)  # the wrapper: a buffer, the arguments, the launch
        plain_ms = cuda_ms(lambda: fq.weight_group_forward_ref(gp, ref), 5)
        pass_ms = weight_pass_ms(model)
        results[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "call_ms": call_ms, "pass_ms": pass_ms,
                         **weight_group_bound(gk, False)}
        log(f"[{phase}] grouped weight_fake_quant, {name}: {len(gk)} quantizers, {gk.channels} channels, {gk.total} "
            f"elements, {gk.blocks} blocks; the observing call (train) and the serving call (eval, planted ties) "
            f"bitwise equal to the plain version, written ranges and flags too; kernel {ms:.4f} ms (one launch), "
            f"bound {results[name]['bound_ms'] * 1e3:.2f} us ({results[name]['bound_ms'] / ms:.1%}); the wrapper "
            f"{call_ms:.4f} ms a call, the model's weight pass {pass_ms:.4f} ms (eval, no gradient, host clock); "
            f"plain {plain_ms:.3f} ms")
        pairs[name] = (gk, gp, buf, ref)
    return results, pairs


def weight_pass_ms(model, n: int = 100) -> float:
    """Milliseconds of host clock a ``weight_pass`` of ``model`` takes in eval() mode without gradients (the
    serving forward's): the table's check, the grouped launch and the views, ending in a synchronize."""
    with torch.no_grad():
        with weight_pass(model):
            pass
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            with weight_pass(model):
                pass
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def check_weight_group_bwd(dev, pairs: dict, phase: int = 8) -> dict:
    """Phase 8: the grouped backward kernel against its plain version at each model's full weight set (phase 2's
    groups after their serving call): ``dw`` bitwise, range gradients within SUM_RTOL of sum |term|, with every
    seventh entry's gradient absent and the 2-D entries' gradients transposed in turn (as ``x @ w.t()`` hands them
    back); then the observing state: ``dw = g``, range gradients 0."""
    results = {}
    for name, (gk, gp, buf, ref) in pairs.items():
        gen = torch.Generator(device=dev).manual_seed(8)
        grads, transposed = [], 0
        for i, e in enumerate(gk.entries):
            if i % 7 == 6:
                grads.append(None)
            elif e.w.ndim == 2 and i % 2 == 0:
                grads.append(torch.randn(e.w.shape[::-1], device=dev, generator=gen).t())
                transposed += 1
            else:
                grads.append(torch.randn(e.w.shape, device=dev, generator=gen))
        dk = fq.weight_fake_quant_group_bwd(gk, buf, grads)
        dp = fq.weight_group_backward_ref(gp, ref, grads)
        used_mn, used_mx = (gk.split_ranges(r) for r in gk.scratch(buf)[:2])
        err = 0.0
        for i, (e, g) in enumerate(zip(gk.entries, grads)):
            if g is None:
                if any(d[i] is not None for d in dk):
                    raise AssertionError(f"{name} entry {i}: gradients without a cotangent")
                continue
            err = max(err, compare(f"{name} grouped bwd entry {i} dw", dk[0][i], dp[0][i]))
            mn, mx = used_mn[i], used_mx[i]
            dims = tuple(d for d in range(e.w.ndim) if d != e.ch_axis % e.w.ndim)
            _, terms = fq.weight_bwd_terms(e.w, g, mn, mx, e.n_bits, e.ch_axis)
            exact = fq.route_range_grad(terms.double().sum(dims), mn.double(), mx.double(), e.n_bits, e.s)
            bound = fq.route_range_grad(terms.double().abs().sum(dims), mn.double(), mx.double(), e.n_bits, e.s)
            for got, want, b in zip((dk[1][i], dk[2][i]), exact, bound):
                err = max(err, check_sum(f"{name} grouped bwd entry {i}", got, want, b.abs()))
        observing = buf.clone()
        gk.scratch(observing)[2].fill_(1.0)
        do = fq.weight_fake_quant_group_bwd(gk, observing, grads)
        for i, g in enumerate(grads):
            if g is not None and not (torch.equal(do[0][i], g) and not do[1][i].any() and not do[2][i].any()):
                raise AssertionError(f"{name} entry {i}: the observing backward is not (g, 0, 0)")
        full = [torch.randn(e.w.shape, device=dev, generator=gen) for e in gk.entries]
        ms = cuda_ms(fq.group_kernel_call(gk, full), 200)
        call_ms = cuda_ms(lambda: fq.weight_fake_quant_group_bwd(gk, buf, full), 200)
        plain_ms = cuda_ms(lambda: fq.weight_group_backward_ref(gp, ref, full), 3)
        results[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "call_ms": call_ms,
                         **weight_group_bound(gk, True)}
        log(f"[{phase}] grouped weight_fake_quant backward, {name}: {len(gk)} quantizers ({transposed} transposed "
            f"gradients, {sum(g is None for g in grads)} absent): dw bitwise equal, range gradients within "
            f"{SUM_RTOL} of sum |term|; the observing state (g, 0, 0); kernel {ms:.4f} ms (one launch), bound "
            f"{results[name]['bound_ms'] * 1e3:.2f} us ({results[name]['bound_ms'] / ms:.1%}); the wrapper "
            f"{call_ms:.4f} ms a call; plain {plain_ms:.3f} ms")
        del dk, dp, do, full
    return results


def build_served_model(dev, mix: np.ndarray, spec: QuantSpec = SPEC, **arch) -> ConvTasNet:
    """Seeded full-width model whose ranges come from a 3-step observer pass in train mode."""
    q_obs = dataclasses.replace(spec, observer=True, max_observations=3)
    model = ConvTasNet(n_srcs=2, kernel_size=16, stride=8, q=q_obs,
                       generator=torch.Generator().manual_seed(0), **arch).to(dev)
    model.train()
    x = torch.from_numpy(mix).to(dev)
    with torch.no_grad():
        for _ in range(3):
            model(x)
    served = ConvTasNet(n_srcs=2, kernel_size=16, stride=8, q=spec, **arch)
    served.load_state_dict(model.state_dict())
    return served.to(dev).eval()


def snr_db(ref: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    return 10 * torch.log10(ref.pow(2).sum(-1) / (ref - est).pow(2).sum(-1))


def serve_requests(dev, state: dict, model_cfg: dict, engine: str = "folded", seconds: int = 20) -> list[float]:
    """Serve three synthetic mixtures through the infer entry, the model's weights and ranges from ``state``;
    returns each request's seconds."""
    latencies = []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "model_fqss8bit.pt")
        torch.save(state, ckpt)
        conf = {"model_cfg": {**model_cfg, "model_path": ckpt},
                "testing_cfg": {"segment_samples": 16000, "overlap": 0.25}}
        apply_fn = infer.load_engine(conf["model_cfg"], engine, dev)
        mixes, _ = synth_batch(np.random.default_rng(2), 3, 2, seconds * SR)
        for i, mix in enumerate(mixes):
            path = os.path.join(tmp, f"mixture_{i}.wav")
            save_audio(path, mix, SR)
            t0 = time.perf_counter()
            out_dir, out = infer.separate_file(apply_fn, conf, path, os.path.join(tmp, f"out_{i}"), device=dev)
            latencies.append(time.perf_counter() - t0)
            if not np.isfinite(out).all():
                raise AssertionError(f"request {i}: non-finite output")
            for s in range(2):
                wav, fs = read_audio(os.path.join(out_dir, f"source_{s + 1}.wav"))
                if wav.shape[-1] != mix.shape[-1] or fs != SR:
                    raise AssertionError(f"request {i} source {s + 1}: {wav.shape[-1]} samples at {fs} Hz, "
                                         f"expected {mix.shape[-1]} at {SR}")
    return latencies


def int8_case(dev, m: int, k: int, n: int, gen: torch.Generator):
    """Random int8 operands [M, K] and [N, K], per-channel scale and corr, with planted extremes and ties.

    Row 0 of xs is all -128, against output channel 0 of all -128 and channel N-1 of all 127: the
    largest |acc| of the shape, 128 * 128 * K. Channels 1..8 (where N allows) pick one activation each,
    with scale = INT8_TIE_DELTA and corr = INT8_TIE_DELTA / 2, so their outputs lie on exact half steps
    of the out grid (INT8_TIE_DELTA, INT8_TIE_MN): (v - mn) / delta = x + 128.5."""
    xs = torch.randint(-128, 128, (m, k), device=dev, generator=gen, dtype=torch.int8)
    w = torch.randint(-128, 128, (n, k), device=dev, generator=gen, dtype=torch.int8)
    scale = (torch.rand(n, device=dev, generator=gen) * 1.5 + 0.5) * 1e-4
    corr = torch.randn(n, device=dev, generator=gen) * 0.5
    xs[0] = -128
    w[0], w[-1] = -128, 127
    ties = torch.arange(1, min(9, n - 1), device=dev)
    w[ties] = 0
    w[ties, (ties - 1) % k] = 1
    scale[ties], corr[ties] = INT8_TIE_DELTA, INT8_TIE_DELTA / 2
    return xs, w, scale, corr


def check_int8_kernel(dev) -> dict:
    """Phase 12: K4 against its plain version, bitwise, at the engine's shapes and odd ones; times per forward."""
    gen = torch.Generator(device=dev).manual_seed(12)
    results = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "int_mm_ms": 0.0}
    bytes_moved = ops = 0
    args = (INT8_TIE_DELTA, INT8_TIE_MN)
    for k, n, per_forward in INT8_SHAPES:
        xs, w, scale, corr = int8_case(dev, INT8_ROWS, k, n, gen)
        for alpha in (1.0, 0.25, 0.0):
            got = im.int8_matmul_requant(xs, w, scale, corr, alpha, *args)
            compare(f"int8_matmul_requant [{INT8_ROWS},{k}]x[{n},{k}] alpha={alpha}", got,
                    im.int8_matmul_requant_ref(xs, w, scale, corr, alpha, *args))
        ms = cuda_ms(lambda: im.int8_matmul_requant(xs, w, scale, corr, 0.25, *args), 20)
        plain_ms = cuda_ms(lambda: im.int8_matmul_requant_ref(xs, w, scale, corr, 0.25, *args), 3)
        int_mm_ms = cuda_ms(lambda: torch._int_mm(xs, w.t()), 20)
        moved, launch_ops = int8_bound(INT8_ROWS, k, n)
        b = bound_of(moved, launch_ops, INT8_OPS_S)
        log(f"[12] int8_matmul_requant [{INT8_ROWS},{k}] x [{n},{k}]: bitwise equal for alpha 1, 0.25, 0 with "
            f"planted extremes and ties; kernel {ms:.4f} ms ({moved / ms / 1e6:.0f} GB/s of {moved / 1e9:.3f} GB, "
            f"{b['bound_ms'] / ms:.1%} of its {b['bound_ms']:.4f} ms bound by {b['bound_by']}), "
            f"plain {plain_ms:.3f} ms, "
            f"torch._int_mm (product only, int32 out) {int_mm_ms:.4f} ms; {per_forward} launches per forward")
        results["ms"] += per_forward * ms
        results["plain_ms"] += per_forward * plain_ms
        results["int_mm_ms"] += per_forward * int_mm_ms
        bytes_moved += per_forward * moved
        ops += per_forward * launch_ops
        del xs, w, got
        torch.cuda.empty_cache()
    results.update(bound_of(bytes_moved, ops, INT8_OPS_S))
    for m in (1, 17, 1023):
        xs, w, scale, corr = int8_case(dev, m, 48, 40, gen)
        for alpha in (1.0, 0.25, 0.0):
            compare(f"int8_matmul_requant [{m},48]x[40,48] alpha={alpha}",
                    im.int8_matmul_requant(xs, w, scale, corr, alpha, *args),
                    im.int8_matmul_requant_ref(xs, w, scale, corr, alpha, *args))
    log(f"[12] int8_matmul_requant at M 1, 17, 1023 x K 48 x N 40, alpha 1, 0.25, 0: bitwise equal; one forward's "
        f"74 launches: kernel {results['ms']:.3f} ms, bound {results['bound_ms']:.3f} ms "
        f"({results['bound_ms'] / results['ms']:.1%}), plain {results['plain_ms']:.1f} ms, "
        f"torch._int_mm {results['int_mm_ms']:.3f} ms")
    return results


def int8_sites(model: ConvTasNet) -> int:
    """The 1x1 convs that the int8 engine runs through K4: all of the masker's, the mask conv only with ReLU."""
    n = sum(isinstance(m, QConv1d) and m.weight.shape[-1] == 1 for m in model.masker.modules())
    return n if model.masker.mask_conv.nl.kind == "relu" else n - 1


def out_step(model: ConvTasNet) -> float:
    aq = model.decoder.activation_fake_quantize
    return float(aq.max_range.detach() - aq.min_range.detach()) / 255.0


def int8_engine_at_full_width(dev, served: ConvTasNet, x: torch.Tensor, y: torch.Tensor,
                              floor: tuple[float, float]) -> tuple[dict, int]:
    """Phase 13: the int8 engines against the fake-quant forward ``y``; returns them and the f32 run's K4 launches.

    ``floor``: (SNR in dB, mean |difference| in output steps) of the fake-quant forward against itself on
    the CPU (phase 4)."""
    sites, lsb = int8_sites(served), out_step(served)
    engines, launches = {}, 0
    for dtype, (snr_margin, mean_factor) in INT8_FLOOR.items():
        engine = engines[dtype] = make_int8_engine(served, compute_dtype=dtype)
        fq.reset_launches()
        im.reset_launches()
        y8 = engine(x)
        torch.cuda.synchronize()
        got = {"int8_mm": im.LAUNCHES["int8_mm"], **fq.LAUNCHES}
        if got != {"int8_mm": sites, "act": 0, "weight": 0, "act_bwd": 0, "weight_bwd": 0}:
            raise AssertionError(f"int8 engine ({dtype}) launches {got}, expected {sites} int8_mm and no other")
        if dtype == "float32":
            launches = got["int8_mm"]
        if y8.shape != y.shape or not torch.isfinite(y8).all():
            raise AssertionError(f"int8 engine ({dtype}) gave shape {tuple(y8.shape)}, "
                                 f"finite={bool(torch.isfinite(y8).all())}")
        diff = (y8 - y).abs()
        max_lsb, mean_lsb = diff.max().item() / lsb, diff.mean().item() / lsb
        snr = snr_db(y, y8)
        snr_min, mean_max = floor[0] - snr_margin, floor[1] * mean_factor
        if snr.min().item() < snr_min or mean_lsb > mean_max:
            raise AssertionError(f"int8 engine ({dtype}) vs fake-quant: SNR {snr.min().item():.2f} dB (minimum "
                                 f"{snr_min:.2f}), mean {mean_lsb:.3f} output steps (maximum {mean_max:.3f})")
        log(f"[13] int8 engine ({dtype} float convs) {tuple(x.shape)} -> {tuple(y8.shape)}, finite; launches "
            f"int8_mm={sites} (= 1x1 convs of the module tree), fake-quant 0; vs fake-quant forward SNR "
            f"{snr.min().item():.2f}-{snr.max().item():.2f} dB (>= {snr_min:.2f}), mean {mean_lsb:.4f} output steps "
            f"(<= {mean_max:.3f}), max {max_lsb:.2f}")
        del y8, diff
    cpu_model = ConvTasNet(n_srcs=2, kernel_size=16, stride=8, q=SPEC)
    cpu_model.load_state_dict(served.state_dict())
    cpu_model.eval()
    x1 = x[:1, :SR]
    for dtype, (snr_min, share_max) in INT8_CARD_VS_CPU.items():
        y_card = engines[dtype](x1).cpu()
        y_cpu = make_int8_engine(cpu_model, compute_dtype=dtype)(x1.cpu())
        snr, share = snr_db(y_cpu, y_card), ((y_card - y_cpu).abs() > 0.5 * lsb).float().mean().item()
        if not bool((snr >= snr_min).all()) or share > share_max:
            raise AssertionError(f"int8 engine ({dtype}) card vs CPU: SNR {snr.tolist()} dB (minimum {snr_min}), "
                                 f"{share} of samples half a step apart (maximum {share_max})")
        log(f"[13] int8 engine ({dtype}) card vs CPU at 1 x {SR}: SNR {[round(v, 2) for v in snr.flatten().tolist()]} "
            f"dB (>= {snr_min}), {(y_card != y_cpu).float().mean().item():.4f} of samples differ, {share:.4f} by "
            f"more than half a step (<= {share_max})")
    return engines, launches


def int8_engine_with_trained_residual_decoder(dev, mix: np.ndarray) -> None:
    """Phase 13, the combiner's trained residual decoder (``train_res_dec``): the full-width ConvTasNet built with
    it, its int8 engine (float32) against its fake-quant forward on 4 x 12 s at the forward's own card-vs-CPU
    floor, with phase 13's rule (INT8_FLOOR). An engine that decodes the residual plane with the shared decoder
    weight instead reads far below that floor."""
    spec = dataclasses.replace(SPEC, train_res_dec=True)
    served = build_served_model(dev, mix[:4], spec)
    if served.decoder.residual_error_block.residual_decoder_weight is None:
        raise AssertionError("train_res_dec built no residual decoder")
    cpu_model = ConvTasNet(n_srcs=2, kernel_size=16, stride=8, q=spec)
    cpu_model.load_state_dict(served.state_dict())
    cpu_model.eval()
    x1 = torch.from_numpy(mix[:1, :SR])
    lsb = out_step(served)
    with torch.inference_mode():
        y_card, y_cpu = served(x1.to(dev)).cpu(), cpu_model(x1)
    snr = snr_db(y_cpu, y_card)
    floor = (snr.min().item(), (y_card - y_cpu).abs().mean().item() / lsb)
    x = torch.from_numpy(mix[:4]).to(dev)
    with torch.inference_mode():
        y = served(x)
    y8 = make_int8_engine(served, compute_dtype="float32")(x)
    snr_margin, mean_factor = INT8_FLOOR["float32"]
    snr8, mean8 = snr_db(y, y8), (y8 - y).abs().mean().item() / lsb
    snr_min, mean_max = floor[0] - snr_margin, floor[1] * mean_factor
    log(f"[13] with the trained residual decoder (train_res_dec): fake-quant card vs CPU floor {floor[0]:.2f} dB, "
        f"{floor[1]:.4f} output steps; int8 engine (float32) vs fake-quant on {tuple(x.shape)}: SNR "
        f"{snr8.min().item():.2f}-{snr8.max().item():.2f} dB (>= {snr_min:.2f}), mean {mean8:.4f} output steps "
        f"(<= {mean_max:.3f})")
    if snr8.min().item() < snr_min or mean8 > mean_max:
        raise AssertionError(f"int8 engine with train_res_dec vs fake-quant: SNR {snr8.min().item():.2f} dB (minimum "
                             f"{snr_min:.2f}), mean {mean8:.3f} output steps (maximum {mean_max:.3f})")


def evaluate_engines(dev, served: ConvTasNet) -> dict:
    """Phase 16: ``val.evaluate`` of the fake_quant and int8 engines on 4 synthetic 3 s mixtures."""
    mixes, sources = synth_batch(np.random.default_rng(16), 4, 2, 3 * SR)
    with tempfile.TemporaryDirectory() as tmp:
        for i, (mix, src) in enumerate(zip(mixes, sources)):
            save_audio(os.path.join(tmp, "test", "mix_clean", f"utt{i}.wav"), mix, SR)
            for s in range(2):
                save_audio(os.path.join(tmp, "test", f"s{s + 1}", f"utt{i}.wav"), src[s], SR)
        ckpt = os.path.join(tmp, "convtasnet_fqss8bit.pt")
        torch.save(served.state_dict(), ckpt)
        conf = {"model_cfg": {**MODEL_CFG, "model_path": ckpt}, "dataset_cfg": {"name": "librimix"},
                "testing_cfg": {"test_dir": os.path.join(tmp, "test"), "segment_samples": 16000, "overlap": 0.25}}
        results = {engine: val.evaluate(conf, engine, dev) for engine in ("fake_quant", "int8")}
    for engine, m in results.items():
        if not np.isfinite(list(m.values())).all():
            raise AssertionError(f"evaluation of {engine}: non-finite metrics {m}")
        log(f"[16] val.evaluate --engine {engine}, 4 mixtures of 3 s: "
            + ", ".join(f"{k} {v:.4f}" for k, v in m.items()))
    gap = abs(results["int8"]["si_sdr"] - results["fake_quant"]["si_sdr"])
    if gap > EVAL_SISDR_DB:
        raise AssertionError(f"int8 mean SI-SDR {gap:.3f} dB from fake_quant's (bound {EVAL_SISDR_DB})")
    log(f"[16] int8 vs fake_quant mean SI-SDR: {gap:.4f} dB apart (<= {EVAL_SISDR_DB})")
    return results


def new_train_state(model: ConvTasNet, teacher: ConvTasNet) -> TrainState:
    return TrainState(model, make_optimizer(TrainConfig(), [p for p in model.parameters() if p.requires_grad]),
                      teacher)


def count_quantizers(modules) -> dict:
    modules = list(modules)
    return {"act": sum(isinstance(m, ActQuantizer) for m in modules),
            "weight": sum(isinstance(m, WeightQuantizer) for m in modules)}


def backward_quantizers(model: ConvTasNet) -> dict:
    """The quantizer modules whose outputs reach the loss: all but the last TCN block's residual
    branch (its res_conv and add), whose output the masker discards, so autograd never reaches it."""
    last = model.masker.blocks[-1]
    dead = {id(m) for branch in (last.res_conv, last.add) for m in branch.modules()}
    return count_quantizers(m for m in model.modules() if id(m) not in dead)


def range_params(model: ConvTasNet) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters() if n.endswith("_range")}


def train_at_full_width(dev) -> tuple[TrainState, dict]:
    """Phase 9: KD train steps of 2 x 3 s through an observer window of 3 steps.

    Returns the state and the launch counts of the whole run."""
    model, teacher = create_model_and_teacher(TRAIN_CFG, generator=torch.Generator().manual_seed(0))
    state = new_train_state(model.to(dev), teacher.to(dev))
    step = make_train_step(TrainConfig())
    fwd, bwd = count_quantizers(model.modules()), backward_quantizers(model)
    want = {"act": fwd["act"], "weight": 1, "act_bwd": bwd["act"], "weight_bwd": 1}  # the weight pass: one each way
    window = TRAIN_CFG["quantization"]["max_observations"]
    rng = np.random.default_rng(9)
    batches = [synth_batch(rng, 2, 2, TRAIN_SEG) for _ in range(TRAIN_STEPS)]
    losses = []
    fq.reset_launches()
    for i, (mix, src) in enumerate(batches):
        before = dict(fq.LAUNCHES)
        metrics = step(state, torch.from_numpy(mix).to(dev), torch.from_numpy(src).to(dev))
        got = {k: fq.LAUNCHES[k] - before[k] for k in fq.LAUNCHES}
        if got != want:
            raise AssertionError(f"train step {i}: launches {got} != {want}")
        losses.append(float(metrics["loss"]))
        if i == window - 1:
            at_window_end = range_params(state.model)
    launches = dict(fq.LAUNCHES)
    if not np.isfinite(losses).all() or state.skipped:
        raise AssertionError(f"losses {losses}, skipped {state.skipped}")
    # Each quantizer that reaches the loss moves at least one of its ranges (with |mn| != |mx| a
    # per-channel weight range gives its gradient to the larger one only).
    after = range_params(state.model)
    moved = len({n.rsplit(".", 1)[0] for n in after if not torch.equal(after[n], at_window_end[n])})
    if moved != bwd["act"] + bwd["weight"]:
        raise AssertionError(f"the ranges of {moved} quantizers moved after the observer window, expected "
                             f"{bwd['act'] + bwd['weight']}")
    log(f"[9] KD train at full width, {TRAIN_STEPS} steps of 2 x {TRAIN_SEG // SR} s, observer window {window}: "
        f"losses {[round(v, 3) for v in losses]} dB, finite, skipped 0; the ranges of {moved} quantizers moved "
        f"after the window; every step launched act={want['act']} forward (= act quantizer modules) and "
        f"act_bwd={want['act_bwd']} backward (= act quantizers reaching the loss; the last block's residual branch "
        f"feeds nothing), and the {fwd['weight']} weight quantizers ({bwd['weight']} reaching the loss) in "
        f"weight={want['weight']} and weight_bwd={want['weight_bwd']} grouped launches")
    return state, launches


def card_vs_cpu_step(dev, state: TrainState, phase: int = 10) -> tuple[float, float]:
    """Phase 10 (and 69): one post-window train step from the same state on the card and on the CPU.

    Returns (|loss difference| in dB, cosine of the whole clipped gradients)."""
    mix, src = synth_batch(np.random.default_rng(10), 1, 2, SR)
    out = []
    for device in (dev, torch.device("cpu")):
        st = new_train_state(copy.deepcopy(state.model).to(device), copy.deepcopy(state.teacher).to(device))
        metrics = make_train_step(TrainConfig())(st, torch.from_numpy(mix).to(device),
                                                 torch.from_numpy(src).to(device))
        grads = torch.cat([p.grad.flatten().double().cpu() for p in st.model.parameters() if p.grad is not None])
        out.append((float(metrics["loss"]), grads))
    (loss_card, g_card), (loss_cpu, g_cpu) = out
    diff = abs(loss_card - loss_cpu)
    cos = float(g_card @ g_cpu / (g_card.norm() * g_cpu.norm()))
    if not (diff <= LOSS_DB_TOL and cos >= GRAD_COS_MIN):
        raise AssertionError(f"card vs CPU train step: loss {loss_card} vs {loss_cpu} dB (tolerance {LOSS_DB_TOL}), "
                             f"gradient cosine {cos} (minimum {GRAD_COS_MIN})")
    log(f"[{phase}] card vs CPU train step at 1 x {SR}: loss {loss_card:.5f} vs {loss_cpu:.5f} dB (|diff| {diff:.2e} <= "
        f"{LOSS_DB_TOL}), whole-gradient cosine {cos:.6f} (>= {GRAD_COS_MIN}) over {g_card.numel()} values")
    return diff, cos


def train_step_time(dev, state: TrainState, smi: str) -> tuple[float, float]:
    """Phase 11: ms per train step at 16 x 3 s by CUDA events, and the peak device memory in GB."""
    mix, src = synth_batch(np.random.default_rng(11), TRAIN_BATCH, 2, TRAIN_SEG)
    x, s = torch.from_numpy(mix).to(dev), torch.from_numpy(src).to(dev)
    step = make_train_step(TrainConfig())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(lambda: step(state, x, s), 5)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if state.skipped:
        raise AssertionError(f"{state.skipped} train steps skipped")
    audio_s = TRAIN_BATCH * TRAIN_SEG / SR
    log(f"[11] train step {TRAIN_BATCH} x {TRAIN_SEG // SR} s: {ms:.1f} ms per step, {audio_s / (ms / 1000):.1f} "
        f"sec-audio trained/s; peak memory {peak_gb:.2f} GB ({(peak_gb - base / 1e9) / TRAIN_BATCH:.3f} GB per "
        f"batch element above the {base / 1e9:.2f} GB held before) on {smi}")
    return ms, peak_gb


def dpt_lstm_shapes(batch: int, seconds_samples: int, model: DPTNet) -> list[tuple[str, int, int, int]]:
    """(side, T, B', H) of the full-width DPTNet's row and column LSTMs at ``batch`` x ``seconds_samples``."""
    frames = seconds_samples - model.kernel_size + 1  # the encoder's stride is kernel_size // 2 = 1
    segs, _ = split_segments(torch.empty(1, frames, 1), model.separator.segment_size)
    k, s = segs.shape[1], segs.shape[2]
    return [("row", k, batch * s, model.hidden_dim), ("col", s, batch * k, model.hidden_dim)]


def lstm_bound(dirs: int, T: int, B: int, H: int) -> tuple[int, int]:
    """Bytes (ih in, W in, hs out, float32) and operations (the recurrent product and the ih add) of a launch."""
    return 4 * dirs * (T * B * 4 * H + H * 4 * H + T * B * H), dirs * T * B * (8 * H * H + 4 * H)


def swap_if(t: torch.Tensor, H: int) -> torch.Tensor:
    """The i and f gate columns of ``[..., 4H]`` exchanged: a recurrence on these reads its gates swapped."""
    return torch.cat([t[..., H : 2 * H], t[..., :H], t[..., 2 * H :]], dim=-1).contiguous()


def torch_lstm_like(q_lstm: QLSTM) -> torch.nn.LSTM:
    """cuDNN's ``nn.LSTM`` with a float QLSTM's weights (torch keeps them transposed)."""
    H = q_lstm.fw.w_hh.shape[0]
    cell = torch.nn.LSTM(q_lstm.fw.w_ih.shape[0], H, batch_first=True, bidirectional=q_lstm.bw is not None)
    with torch.no_grad():
        for suffix, d in (("", q_lstm.fw), ("_reverse", q_lstm.bw)):
            if d is not None:
                getattr(cell, f"weight_ih_l0{suffix}").copy_(d.w_ih.t())
                getattr(cell, f"weight_hh_l0{suffix}").copy_(d.w_hh.t())
                getattr(cell, f"bias_ih_l0{suffix}").copy_(d.b_ih)
                getattr(cell, f"bias_hh_l0{suffix}").copy_(d.b_hh)
    return cell.to(q_lstm.fw.w_ih.device)


def plan_text(dev, B: int, H: int, dirs: int) -> str:
    """The launch plan K7 (dirs 2) or K6 (dirs 1) takes at B' x H on this card."""
    p = lk.launch_plan(dev, B, H, dirs)
    if p.route == "blocks":
        return f"blocks route, {p.rows}-row blocks, {p.units} blocks"
    return (f"clusters of {p.cluster}, {p.rows}-row tiles, {p.units} clusters = {p.ctas} CTAs (co-resident "
            f"{lk.coresident(dev, H)})")


def check_lstm_kernels(dev, shapes: list[tuple[str, int, int, int]], per_forward: int,
                       stream_shapes: list[tuple[str, int, int, int]]) -> tuple[dict, dict]:
    """Phase 17: K7 and K6 against their plain versions; K7's times per forward (``per_forward`` launches at
    each shape of ``shapes``), K6's per launch at the row shape; both at the streamed window's ``stream_shapes``.
    Returns (K6 results, K7 results)."""
    gen = torch.Generator(device=dev).manual_seed(17)
    k6 = {"max_abs_err": 0.0}
    k7 = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    moved = ops = 0
    for side, T, B, H in [*shapes, *stream_shapes, ("odd", *LSTM_ODD)]:
        ih = [torch.randn(T, B, 4 * H, device=dev, generator=gen) * 0.5 for _ in range(2)]
        w = [(torch.rand(H, 4 * H, device=dev, generator=gen) * 2 - 1) / math.sqrt(H) for _ in range(2)]
        with torch.no_grad():
            hf, hb = lk.bilstm_sequence(ih[0], ih[1], w[0], w[1])
            h1 = lk.lstm_sequence(ih[1], w[1])
            rf, rb = lk.bilstm_sequence_ref(ih[0], ih[1], w[0], w[1])
        torch.cuda.synchronize()
        err7 = max((hf - rf).abs().max().item(), (hb - rb).abs().max().item())
        err6 = (h1 - rb).abs().max().item()
        if not (err7 <= LSTM_TOL and err6 <= LSTM_TOL):
            raise AssertionError(f"LSTM kernel at T {T} x B' {B} x H {H}: max |difference| K7 {err7}, K6 {err6} "
                                 f"> {LSTM_TOL}")
        k6["max_abs_err"], k7["max_abs_err"] = max(k6["max_abs_err"], err6), max(k7["max_abs_err"], err7)
        swapped = (lk.lstm_sequence_ref(swap_if(ih[0], H), swap_if(w[0], H)) - rf).abs().max().item()
        unflipped = (lk.lstm_sequence_ref(ih[1].flip(0), w[1]).flip(0) - rb).abs().max().item()
        line = (f"[17] LSTM kernel {side} T {T} x B' {B} x H {H}: K7 {plan_text(dev, B, H, 2)}, K6 "
                f"{plan_text(dev, B, H, 1)}; max |kernel - plain| K7 {err7:.3g}, K6 {err6:.3g} "
                f"(<= {LSTM_TOL}); i/f swapped would read {swapped:.3g}, the reverse direction unflipped "
                f"{unflipped:.3g}")
        if side == "odd":
            log(line)
            continue
        b7, b6 = bound_of(*lstm_bound(2, T, B, H), F32_OPS_S), bound_of(*lstm_bound(1, T, B, H), F32_OPS_S)
        if side.startswith("stream"):
            ms7 = cuda_ms(lambda: lk.bilstm_sequence(ih[0], ih[1], w[0], w[1]), 10)
            ms6 = cuda_ms(lambda: lk.lstm_sequence(ih[0], w[0]), 10)
            log(f"{line}; K7 {ms7:.4f} ms ({b7['bound_ms'] / ms7:.1%} of its {b7['bound_ms']:.4f} ms bound by "
                f"{b7['bound_by']}), K6 {ms6:.4f} ms ({b6['bound_ms'] / ms6:.1%} of {b6['bound_ms']:.4f})")
            del ih, w, hf, hb, rf, rb, h1
            continue
        ms7 = cuda_ms(lambda: lk.bilstm_sequence(ih[0], ih[1], w[0], w[1]), 10)
        ms6 = cuda_ms(lambda: lk.lstm_sequence(ih[0], w[0]), 10)
        # the plain time loops (~50-90 ms a call, host-bound: 250 steps of a few small launches) by the median
        plain7, lo7, hi7 = median_ms(lambda: lk.bilstm_sequence_ref(ih[0], ih[1], w[0], w[1]), LSTM_PLAIN_REPS)
        plain6, lo6, hi6 = median_ms(lambda: lk.lstm_sequence_ref(ih[0], w[0]), LSTM_PLAIN_REPS)
        # cuDNN's LSTM on the same weights and input, with its own input projection, beside the port's QLSTM
        # (the projection in one product, then K7); float32, TF32 off.
        q_bi = QLSTM(64, H, generator=torch.Generator().manual_seed(T)).to(dev)
        q_uni = QLSTM(64, H, bidirectional=False, generator=torch.Generator().manual_seed(T)).to(dev)
        x = torch.randn(B, T, 64, device=dev, generator=gen)
        with torch.no_grad():
            cudnn_bi, cudnn_uni = torch_lstm_like(q_bi), torch_lstm_like(q_uni)
            agree = (cudnn_bi(x)[0] - q_bi(x)).abs().max().item()
            lib7 = cuda_ms(lambda: cudnn_bi(x), 5)
            lib6 = cuda_ms(lambda: cudnn_uni(x), 5)
            qlstm_ms = cuda_ms(lambda: q_bi(x), 5)
        log(f"{line}; K7 {ms7:.3f} ms ({b7['bound_ms'] / ms7:.1%} of its {b7['bound_ms']:.3f} ms bound by "
            f"{b7['bound_by']}), K6 {ms6:.3f} ms ({b6['bound_ms'] / ms6:.1%} of {b6['bound_ms']:.3f}), plain "
            f"{plain7:.1f} / {plain6:.1f} ms (medians of {LSTM_PLAIN_REPS}, {lo7:.1f}-{hi7:.1f} / {lo6:.1f}-{hi6:.1f}); "
            f"cuDNN nn.LSTM bidirectional {lib7:.3f} ms, unidirectional "
            f"{lib6:.3f} ms, against the port's QLSTM (projection + K7) {qlstm_ms:.3f} ms; cuDNN vs QLSTM max "
            f"|difference| {agree:.3g}")
        k7["ms"] += per_forward * ms7
        k7["plain_ms"] += per_forward * plain7
        k7["library_ms"] += per_forward * lib7
        b_moved, b_ops = lstm_bound(2, T, B, H)
        moved, ops = moved + per_forward * b_moved, ops + per_forward * b_ops
        if side == "row":
            k6.update(ms=ms6, plain_ms=plain6, library_ms=lib6, **b6)
        del ih, w, hf, hb, rf, rb, h1, x, q_bi, q_uni, cudnn_bi, cudnn_uni
        torch.cuda.empty_cache()
    k7.update(bound_of(moved, ops, F32_OPS_S))
    log(f"[17] one DPTNet forward's {2 * per_forward} K7 launches: {k7['ms']:.2f} ms against a "
        f"{k7['bound_ms']:.2f} ms bound by {k7['bound_by']} ({k7['bound_ms'] / k7['ms']:.1%}), plain "
        f"{k7['plain_ms']:.1f} ms, cuDNN nn.LSTM {k7['library_ms']:.2f} ms")
    return k6, k7


def build_served_dptnet(dev, mix: np.ndarray, steps: int = DPT_OBSERVE_STEPS) -> DPTNet:
    """The full-width DPTNet from ``create_pretrained_model``; ranges from ``steps`` observer steps on ``mix``."""
    cfg = {**DPTNET_CFG, "quantization": {**DPTNET_CFG["quantization"], "max_observations": steps}}
    observer = create_pretrained_model(cfg, observer=True, device=dev).train()
    x = torch.from_numpy(mix).to(dev)
    with torch.no_grad():
        for _ in range(steps):
            observer(x)
    served = create_pretrained_model(DPTNET_CFG, observer=False, device=dev)
    served.load_state_dict(observer.state_dict())
    return served


def all_launches() -> dict:
    return {**fq.LAUNCHES, **lk.LAUNCHES, **im.LAUNCHES, **k8.LAUNCHES, **qd.LAUNCHES, **qm.LAUNCHES}


def reset_all_launches() -> None:
    for module in (fq, lk, im, k8, qd, qm):
        module.reset_launches()


def dense_quantizers(model) -> dict:
    """The QDense layers and their quantizers, whose grids K5 applies (no K1 or K2 launch of their own); ``dense``
    also counts the attentions' projections, K5's core with both grids off: a self-attention's in- and
    out-projection, a cross-attention's query, key (= value) and out-projection."""
    layers = [m for m in model.modules() if isinstance(m, QDense)]
    projections = sum(3 if name.endswith("cross_attn") else 2 for name, m in model.named_modules()
                      if isinstance(m, QMultiheadAttention))
    return {"dense": len(layers) + projections, "act": sum(m.activation_fake_quantize is not None for m in layers),
            "weight": sum(m.weight_fake_quantize is not None for m in layers)}


def fused_convs(model) -> dict:
    """The QConv1d layers that run on K3 where no gradient is needed, and their quantizers, whose grids K3
    applies (no K1 or K2 launch of their own)."""
    layers = [m for m in model.modules() if isinstance(m, QConv1d) and m.fused]
    return {"qmatmul": len(layers), "act": sum(m.activation_fake_quantize is not None for m in layers),
            "weight": sum(m.weight_fake_quantize is not None for m in layers)}


def record_k3_inputs(model, name: str) -> tuple[list, list]:
    """Hooks on ``model``'s K3 layers that record (name, B, K, T, N) of every input they take; returns the list
    and the hooks' handles."""
    seen = []
    handles = [m.register_forward_pre_hook(lambda mod, args: seen.append((name, *args[0].shape, mod.weight.shape[0])))
               for m in model.modules() if isinstance(m, QConv1d) and m.fused]
    return seen, handles


def no_launches(**counts) -> dict:
    """The launch counters all at 0 but ``counts``."""
    return {**{k: 0 for k in all_launches()}, **counts}


def dptnet_int8_sites(model: DPTNet) -> int:
    """The DPTNet int8 engine's K4 launches: BN, out_conv, the two gates, the mask, and in every dual-path layer
    the out-projection and, but for row_0 (off the grid), the in-projection."""
    layers = 2 * model.layer
    return 5 + layers + (layers - 1)


def dptnet_int8_cases(dpt: DPTNet, shapes) -> list[tuple]:
    """(M, K, N, nl, alpha, grids, what, launches per forward) of the DPTNet int8 engine's K4 launches at DPT_BATCH
    x DPT_SEG: BN, each side's in-projection (every dual-path layer's but row_0's) and out-projection, out_conv, the
    gated output's two products and the mask, with the epilogues the engine uses there."""
    frames = DPT_SEG - dpt.kernel_size + 1
    n, e, spk = dpt.feature_dim, dpt.enc_dim, dpt.n_srcs
    one = (INT8_TIE_DELTA, INT8_TIE_MN)
    cases = [(DPT_BATCH * frames, e, n, "prelu", 1.0, one, "BN", 1)]
    for side, T, B, _ in shapes:
        cases += [(T * B, n, 3 * n, "prelu", 1.0, QKV_GRIDS, f"{side} in-projection (three output grids)",
                   dpt.layer - (side == "row")),
                  (T * B, n, n, "prelu", 1.0, one, f"{side} out-projection", dpt.layer)]
    cases += [(shapes[0][1] * shapes[0][2], n, spk * n, "prelu", 1.0, one, "out_conv", 1),
              (DPT_BATCH * spk * frames, n, n, "tanh", 1.0, one, "output", 1),
              (DPT_BATCH * spk * frames, n, n, "sigmoid", 1.0, one, "output_gate", 1),
              (DPT_BATCH * spk * frames, n, e, "prelu", 0.0, one, "mask", 1)]
    return cases


def int8_bound(m: int, k: int, n: int) -> tuple[int, int]:
    """Bytes (activations in, int8 out, weight, scale and corr) and operations of one K4 launch."""
    return m * (k + n) + n * k + 8 * n, 2 * m * k * n


def check_int8_cases(dev, phase: int, engine: str, cases: list[tuple], seed: int, plain: bool = False) -> dict:
    """Phases 22, 29, 49 and 59: K4 against its plain version, bitwise, at an int8 engine's ``cases``; its time, rate
    and share of the bytes bound at each (``plain``: the plain version's time too); summed per forward (the cases'
    launches)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    total = {"ms": 0.0, "bytes": 0, "ops": 0, "launches": 0, "max_abs_err": 0.0, **({"plain_ms": 0.0} if plain else {})}
    for m, k, n_out, nl, alpha, grids, what, per_forward in cases:
        xs, w, scale, corr = int8_case(dev, m, k, n_out, gen)
        if nl != "prelu":  # products spread over the nonlinearity's working range, not only its saturated ends
            scale = scale * 0.05
        args = (xs, w, scale, corr, alpha, *grids)
        total["max_abs_err"] = max(total["max_abs_err"], compare(
            f"int8_matmul_requant {what} [{m},{k}]x[{n_out},{k}] {nl}", im.int8_matmul_requant(*args, nl=nl).float(),
            im.int8_matmul_requant_ref(*args, nl=nl).float()))
        ms = cuda_ms(lambda: im.int8_matmul_requant(*args, nl=nl), 10)
        if plain:
            total["plain_ms"] += per_forward * cuda_ms(lambda: im.int8_matmul_requant_ref(*args, nl=nl), 3)
        moved, ops = int8_bound(m, k, n_out)
        b = bound_of(moved, ops, INT8_OPS_S)
        log(f"[{phase}] int8_matmul_requant at the {engine} engine's {what} [{m},{k}] x [{n_out},{k}], {nl}"
            f"{f' alpha {alpha}' if nl == 'prelu' else ''}: bitwise equal to its plain version; {ms:.4f} ms "
            f"({moved / ms / 1e6:.0f} GB/s, {b['bound_ms'] / ms:.1%} of its {b['bound_ms']:.4f} ms bound by "
            f"{b['bound_by']}); {per_forward} launches per forward")
        total["ms"] += per_forward * ms
        total["bytes"] += per_forward * moved
        total["ops"] += per_forward * ops
        total["launches"] += per_forward
        del xs, w, scale, corr, args
    total.update(bound_of(total["bytes"], total["ops"], INT8_OPS_S))
    log(f"[{phase}] one {engine} int8 forward's {total['launches']} K4 launches: {total['ms']:.3f} ms against a "
        f"{total['bound_ms']:.3f} ms bound by {total['bound_by']} ({total['bound_ms'] / total['ms']:.1%}), "
        f"{total['bytes'] / 1e9:.3f} GB" + (f"; plain {total['plain_ms']:.3f} ms" if plain else ""))
    return total


def int8_engines_vs_fake_quant(phase: int, name: str, model, cpu_model, x: torch.Tensor, y: torch.Tensor,
                               floor: tuple[float, float], want: dict, card_vs_cpu_db: float,
                               dtypes: tuple = tuple(INT8_FLOOR)) -> dict:
    """The int8 engines of ``model`` (``dtypes``: float32, bfloat16 float products) against its fake-quant forward
    ``y``: launches ``want``, phase 13's floor rule, card vs CPU at 1 x 1 s (unless ``cpu_model`` is None); returns
    the engines by compute dtype."""
    lsb, engines = out_step(model), {}
    for dtype in dtypes:
        snr_margin, mean_factor = INT8_FLOOR[dtype]
        engine = engines[dtype] = make_int8_engine(model, compute_dtype=dtype)
        reset_all_launches()
        y8 = engine(x)
        torch.cuda.synchronize()
        got = all_launches()
        if got != want:
            raise AssertionError(f"{name} int8 engine ({dtype}) launches {got} != {want}")
        if y8.shape != y.shape or not torch.isfinite(y8).all():
            raise AssertionError(f"{name} int8 engine ({dtype}) gave shape {tuple(y8.shape)}, "
                                 f"finite={bool(torch.isfinite(y8).all())}")
        diff = (y8 - y).abs()
        snr, mean_lsb = snr_db(y, y8), diff.mean().item() / lsb
        snr_min, mean_max = floor[0] - snr_margin, floor[1] * mean_factor
        if snr.min().item() < snr_min or mean_lsb > mean_max:
            raise AssertionError(f"{name} int8 engine ({dtype}) vs fake-quant: SNR {snr.min().item():.2f} dB "
                                 f"(minimum {snr_min:.2f}), mean {mean_lsb:.3f} output steps (maximum {mean_max:.3f})")
        log(f"[{phase}] {name} int8 engine ({dtype} float products) {tuple(x.shape)} -> {tuple(y8.shape)}, finite; "
            f"launches {', '.join(f'{k}={v}' for k, v in got.items() if v)}, all others 0; vs fake-quant forward SNR "
            f"{snr.min().item():.2f}-{snr.max().item():.2f} dB (>= {snr_min:.2f}), mean {mean_lsb:.4f} output steps "
            f"(<= {mean_max:.3f}), max {diff.max().item() / lsb:.2f}")
        del y8, diff
    x1 = x[:1, :SR]
    for dtype, engine in engines.items():
        if cpu_model is None:
            break
        y_card = engine(x1).cpu()
        y_cpu = make_int8_engine(cpu_model, compute_dtype=dtype)(x1.cpu())
        snr = snr_db(y_cpu, y_card)
        if not bool((snr >= card_vs_cpu_db).all()):
            raise AssertionError(f"{name} int8 engine ({dtype}) card vs CPU SNR {snr.tolist()} dB < {card_vs_cpu_db}")
        log(f"[{phase}] {name} int8 engine ({dtype}) card vs CPU at 1 x {SR}: SNR "
            f"{[round(v, 2) for v in snr.flatten().tolist()]} dB (>= {card_vs_cpu_db}), "
            f"{(y_card != y_cpu).float().mean().item():.4f} of samples differ, mean "
            f"{(y_card - y_cpu).abs().mean().item() / lsb:.4f} output steps")
    return engines


def state_on_cpu(model: torch.nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def serve_dptnet(dev, smi: str) -> tuple:
    """Phases 17-23, the DPTNet serving path. Returns (K6 results, K7 results, the launches of phase 18's
    forward, its attention shapes for phase 24, its K3 shapes for phase 37, the served weights and ranges, K4's
    time and bound per DPTNet int8 forward)."""
    dmix, _ = synth_batch(np.random.default_rng(18), DPT_BATCH, 2, DPT_SEG)
    dpt = build_served_dptnet(dev, dmix[:2])
    shapes = dpt_lstm_shapes(DPT_BATCH, DPT_SEG, dpt)
    # the LSTMs of a streamed window (phase 38: batch 1, STREAM_SEGMENT samples)
    stream_shapes = [(f"stream {side}", T, B, H) for side, T, B, H in dpt_lstm_shapes(1, STREAM_SEGMENT, dpt)]
    k6, k7 = check_lstm_kernels(dev, shapes, dpt.layer, stream_shapes)  # 17.
    torch.cuda.empty_cache()

    # 18. the full-width forward
    counts = count_quantizers(dpt.modules())
    n_mha = sum(isinstance(m, QMultiheadAttention) for m in dpt.modules())
    noop = 2 * n_mha  # attn and softmax sites, skipped
    n_params = sum(p.numel() for n, p in dpt.named_parameters() if "fake_quantize" not in n and ".wq_" not in n)
    x = torch.from_numpy(dmix).to(dev)
    k3_shapes, hooks = record_k3_inputs(dpt, "DPTNet BN")
    reset_all_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        y = dpt(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = all_launches()
    for h in hooks:
        h.remove()
    dense, fused = dense_quantizers(dpt), fused_convs(dpt)
    want = no_launches(act=counts["act"] - noop - n_mha - dense["act"] - fused["act"], weight=1, bilstm=2 * dpt.layer,
                       attention=n_mha, dense=dense["dense"], qmatmul=fused["qmatmul"])
    if tuple(y.shape) != (DPT_BATCH, 2, DPT_SEG) or not torch.isfinite(y).all():
        raise AssertionError(f"DPTNet forward gave shape {tuple(y.shape)}, finite={bool(torch.isfinite(y).all())}")
    if launches != want:
        raise AssertionError(f"DPTNet launches {launches} != {want}")
    log(f"[18] full-width DPTNet {tuple(x.shape)} -> {tuple(y.shape)}, finite, {n_params} parameters, LSTMs "
        f"{', '.join(f'{s} T {T} x B {B}' for s, T, B, _ in shapes)}, first call {first_s:.2f} s; launches "
        f"act={launches['act']} (= {counts['act']} act quantizers - {noop} no-op attention sites - {n_mha} head "
        f"grids in K8's epilogue - {dense['act']} in K5's - {fused['act']} in K3's) weight={launches['weight']} (the "
        f"{counts['weight']} weight quantizers grouped; K5's {dense['weight']} and K3's {fused['weight']} weight "
        f"grids off) bilstm={launches['bilstm']} lstm=0 attention={launches['attention']} "
        f"dense={launches['dense']} (= QDense layers and the attentions' projections) qmatmul={launches['qmatmul']} (= BN, K3: {k3_shapes})")

    # 19. card vs CPU on the same weights
    cpu_dpt = create_pretrained_model(DPTNET_CFG, observer=False)
    cpu_dpt.load_state_dict(dpt.state_dict())
    x1 = torch.from_numpy(dmix[:1, :SR])
    with torch.inference_mode():
        y_card = dpt(x1.to(dev)).cpu()
        y_cpu = cpu_dpt(x1)
    snr = snr_db(y_cpu, y_card)
    if not bool((snr >= 20).all()):
        raise AssertionError(f"DPTNet card vs CPU SNR {snr.tolist()} dB < 20 dB")
    floor = (snr.min().item(), (y_card - y_cpu).abs().mean().item() / out_step(dpt))
    log(f"[19] DPTNet card vs CPU at 1 x {SR}: SNR {[round(v, 2) for v in snr.flatten().tolist()]} dB (>= 20), "
        f"{(y_card != y_cpu).float().mean().item():.4f} of samples differ, mean {floor[1]:.4f} output steps")

    # 20. the folded engine
    folded = fold_quantized_weights(dpt)
    reset_all_launches()
    with torch.inference_mode():
        y_folded = folded(x)
    torch.cuda.synchronize()
    if (lk.LAUNCHES["bilstm"] != 2 * dpt.layer or fq.LAUNCHES["weight"] != 0 or qd.LAUNCHES["dense"] != dense["dense"]
            or qm.LAUNCHES["qmatmul"] != fused["qmatmul"]):
        raise AssertionError(f"the folded DPTNet launched {all_launches()}")
    if not torch.equal(y_folded, y):
        raise AssertionError(f"folded DPTNet != fake-quant, max abs diff {(y_folded - y).abs().max().item()}")
    log(f"[20] folded DPTNet: bitwise equal to fake-quant; act launches {fq.LAUNCHES['act']}, weight 0, "
        f"bilstm {lk.LAUNCHES['bilstm']}, attention {k8.LAUNCHES['attention']}, dense {qd.LAUNCHES['dense']} and "
        f"qmatmul {qm.LAUNCHES['qmatmul']} (K5 and K3 with the weight grid off: the weights are on it)")
    del y_folded
    torch.cuda.empty_cache()

    # 21. requests through the infer entry
    for i, s in enumerate(serve_requests(dev, dpt.state_dict(), DPTNET_CFG)):
        log(f"[21] DPTNet request {i} (folded): 20 s mixture -> 2 sources of 20 s, {s * 1000:.1f} ms")

    # 22. K4 at the int8 engine's shapes, then the engine (launch counts set to 0 inside, read after each forward)
    int8_cases = dptnet_int8_cases(dpt, shapes)
    if sum(c[-1] for c in int8_cases) != dptnet_int8_sites(dpt):
        raise AssertionError(f"phase 22's K4 cases count {sum(c[-1] for c in int8_cases)} launches a forward, the "
                             f"engine {dptnet_int8_sites(dpt)}")
    k4 = check_int8_cases(dev, 22, "DPTNet", int8_cases, 22)
    # K4 = its int8 products; K7 and K1 = the LSTMs and their output quantizers, run as the model runs them
    layers = 2 * dpt.layer
    engines = int8_engines_vs_fake_quant(22, "DPTNet", dpt, cpu_dpt, x, y, floor,
                                         no_launches(act=layers, bilstm=layers, int8_mm=dptnet_int8_sites(dpt)),
                                         DPT_INT8_CARD_VS_CPU_DB)

    # 23. throughput
    audio_s = DPT_BATCH * DPT_SEG / SR
    for name, fn in (("fake_quant", dpt), ("folded", folded), *((f"int8 {d}", e) for d, e in engines.items())):
        with torch.inference_mode():
            ms = cuda_ms(lambda: fn(x), 3)
        log(f"[23] DPTNet throughput {name}: {audio_s / (ms / 1000):.1f} sec-audio/s ({ms:.1f} ms per forward of "
            f"{DPT_BATCH} x {DPT_SEG // SR} s) on {smi}")
    return k6, k7, launches, dptnet_attention_shapes(dpt), k3_shapes, state_on_cpu(dpt), k4


def dptnet_attention_shapes(dpt: DPTNet) -> list[tuple]:
    """(name, BH, Lq, Lk, d, launches per forward, model, heads) of DPTNet's row and column attention at DPT_BATCH
    x DPT_SEG (the layers have 4 heads; their sequences are the LSTMs')."""
    heads, d = 4, dpt.feature_dim // 4
    return [(f"DPTNet {side}", B * heads, T, T, d, dpt.layer, "DPTNet", heads)
            for side, T, B, _ in dpt_lstm_shapes(DPT_BATCH, DPT_SEG, dpt)]


def sepformer_attention_shapes(sep: Sepformer) -> list[tuple]:
    """(name, BH, Lq, Lk, d, launches per forward, model, heads) of the Sepformer's intra- and inter-chunk
    attention at SEP_BATCH x SEP_SEG."""
    frames = (SEP_SEG - sep.encoder.conv.weight.shape[-1]) // sep.encoder.conv.stride + 1
    segs, _ = split_segments(torch.empty(1, frames, 1), sep.masker.chunk_size)
    k, s = segs.shape[1], segs.shape[2]
    h, d = sep.n_heads, sep.n_filters // sep.n_heads
    per_forward = len(sep.masker.blocks) * len(sep.masker.blocks[0].intra_transformer_block.layers)
    return [("Sepformer intra", SEP_BATCH * s * h, k, k, d, per_forward, "Sepformer", h),
            ("Sepformer inter", SEP_BATCH * k * h, s, s, d, per_forward, "Sepformer", h)]


def attention_bound(bh: int, lq: int, lk: int, d: int) -> tuple[int, int]:
    """Bytes (q, k, v in, heads out, float32) and operations (the two products) of a launch."""
    return 4 * (2 * bh * lq * d + 2 * bh * lk * d), 4 * bh * lq * lk * d


def attention_route_bound(bytes_moved: float, ops: float) -> dict:
    """The least time of K8's route: Q K^T on the CUDA cores (half the operations at the float32 peak) beside P V
    as 3 TF32 products a float32 one (the other half at the TF32 peak), the two pipes side by side, or the bytes
    over the memory rate: the largest."""
    b = max(bound_of(bytes_moved, ops / 2, F32_OPS_S), bound_of(bytes_moved, 3 * ops / 2, TF32_OPS_S),
            key=lambda x: x["bound_ms"])
    return {"route_bound_ms": b["bound_ms"], "route_bound_by": b["bound_by"]}


def packed_views(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, h: int) -> tuple:
    """The heads ``[B h, L, d]`` laid out as QMultiheadAttention hands them to the packed entry: q a ``[B, Lq,
    E]`` viewed ``[B, Lq, h, d]``, k and v the E:2E and 2E: thirds of an in-projection ``[B, Lk, 3E]``."""
    bh, lq, d = qs.shape
    B, lk, E = bh // h, k.shape[1], h * d
    X = torch.empty(B, lk, 3 * E, device=qs.device)
    X[..., :E] = 0
    X[..., E:2 * E] = k.reshape(B, h, lk, d).transpose(1, 2).reshape(B, lk, E)
    X[..., 2 * E:] = v.reshape(B, h, lk, d).transpose(1, 2).reshape(B, lk, E)
    Q = qs.reshape(B, h, lq, d).transpose(1, 2).reshape(B, lq, E).contiguous()
    return Q.unflatten(-1, (h, d)), X[..., E:2 * E].unflatten(-1, (h, d)), X[..., 2 * E:].unflatten(-1, (h, d))


def heads_of(packed: torch.Tensor, h: int) -> torch.Tensor:
    """The packed entry's ``[B, Lq, E]`` as ``[B h, Lq, d]``."""
    B, lq, E = packed.shape
    return packed.reshape(B, lq, h, E // h).transpose(1, 2).reshape(B * h, lq, E // h)


def check_attention_kernel(dev, shapes: list[tuple], phase: int = 24, models: tuple = ("Sepformer", "DPTNet"),
                           odd: bool = True) -> dict:
    """Phase 24 (and 59): K8 through both entries against its plain version at ``shapes`` (and ATTN_ODD with
    ``odd``); its times per forward of each of ``models``, the first one's keys unprefixed, the others' prefixed by
    the model's name."""
    gen = torch.Generator(device=dev).manual_seed(phase)
    keys = ("ms", "plain_ms", "library_ms", "moved", "ops")
    sums = {model: dict.fromkeys(keys, 0.0) for model in models}
    launches = {model: 0 for model in sums}
    results = {"max_abs_err": 0.0}
    for name, bh, lq, lk, d, per_forward, model, h in [*shapes, *([("odd", *ATTN_ODD, 0, None, 1)] if odd else [])]:
        qs = torch.randn(bh, lq, d, device=dev, generator=gen) * 0.3
        qs[:, 0] *= ATTN_PLANT
        k, v = (torch.randn(bh, lk, d, device=dev, generator=gen) for _ in range(2))
        views = packed_views(qs, k, v, h)
        with torch.no_grad():
            ref = k8.fused_attention_ref(qs, k, v, quantize=False)
            mn, mx = ref.min().reshape(1), ref.max().reshape(1)
            heads = k8.fused_attention(qs, k, v, quantize=False)
            got = k8.fused_attention(qs, k, v, mn, mx, 8)
            packed = heads_of(k8.fused_attention_packed(*views, quantize=False), h)
            packed_got = heads_of(k8.fused_attention_packed(*views, mn, mx, 8), h)
            plain = k8.fused_attention_ref(qs, k, v, mn, mx, 8)
            # the planted rows' float64 attention, and the same from their exact logits rounded once to float32
            logits = torch.matmul(qs[:, :1].double(), k.double().transpose(-1, -2))
            truth = torch.matmul(torch.softmax(logits, -1), v.double())
            rounded = torch.matmul(torch.softmax(logits.float().double(), -1), v.double())
            del logits
            swapped = (k8.fused_attention_ref(qs, v, k, quantize=False) - ref).abs().max().item()
            p = torch.exp(torch.matmul(qs, k.transpose(-1, -2)))  # no max subtracted
            no_max = (torch.matmul(p, v) / p.sum(-1, keepdim=True) - ref).abs().max().item()
            del p
        torch.cuda.synchronize()
        scale, err = ref.abs().max().item(), (heads - ref).abs().max().item()
        planted = (heads[:, :1].double() - truth).abs().max().item()
        planted_plain = (ref[:, :1].double() - truth).abs().max().item()
        planted_vs_plain = (heads[:, :1] - ref[:, :1]).abs().max().item()
        planted_floor = (rounded - truth).abs().max().item()
        step = (mx - mn).item() / 255
        diff = (got - plain).abs()
        share = (diff > 0.5 * step).float().mean().item()
        if not torch.equal(packed, heads) or not torch.equal(packed_got, got):
            raise AssertionError(f"K8 {name}: the packed entry's heads differ from the [BH, L, d] entry's")
        if not err <= ATTN_REL_TOL * scale:
            raise AssertionError(f"K8 {name} [{bh},{lq},{lk},{d}]: float heads {err:.3g} from the plain version's, "
                                 f"more than {ATTN_REL_TOL} x {scale:.3g}")
        if not torch.equal(got, fq.act_fake_quant_ref(heads, mn, mx, 8)):
            raise AssertionError(f"K8 {name}: the epilogue is not the plain grid of the kernel's own float heads")
        if diff.max().item() > step * (1 + 1e-4) or share > ATTN_GRID_SHARE:
            raise AssertionError(f"K8 {name}: quantized heads {diff.max().item() / step:.3f} steps from the plain "
                                 f"version's, {share:.2e} of them a step apart (at most {ATTN_GRID_SHARE})")
        results["max_abs_err"] = max(results["max_abs_err"], err)
        line = (f"[{phase}] K8 {name} BH {bh} x Lq {lq} x Lk {lk} x d {d} ({k8.plan(bh, lq, lk, d)}): float heads max "
                f"|kernel - plain| {err:.3g} ({err / scale:.2e} of max |heads| {scale:.3g}, <= {ATTN_REL_TOL}), the "
                f"planted rows {planted_vs_plain / scale:.2e}; the planted rows from the float64 attention: kernel "
                f"{planted / scale:.2e}, plain {planted_plain / scale:.2e}, the exact logits rounded once to float32 "
                f"{planted_floor / scale:.2e}"
                f"; on the grid max {diff.max().item() / step:.0f} step, {share:.2e} of values a step apart (<= "
                f"{ATTN_GRID_SHARE}), each its own float head on the plain grid; the packed entry ({h} heads on an "
                f"in-projection's views) bitwise equal; K and V swapped would read {swapped:.3g}, no max subtracted "
                f"{no_max:.3g}")
        if name in ("odd", "Sepformer inter"):  # the backward: the plain composition's gradient at the saved inputs
            g = torch.randn_like(qs)
            for fn, ref_fn, args, gout in ((k8.fused_attention, k8.fused_attention_ref, (qs, k, v), g),
                                           (k8.fused_attention_packed, k8.fused_attention_packed_ref, views,
                                            g.reshape(bh // h, h, lq, d).transpose(1, 2).reshape(bh // h, lq, h * d))):
                grads = []
                for f in (fn, ref_fn):
                    t = [a.clone().requires_grad_(True) for a in (*args, mn, mx)]
                    (f(*t, 8) * gout).sum().backward()
                    grads.append([a.grad for a in t])
                if not all(torch.equal(a, b) for a, b in zip(*grads)):
                    raise AssertionError(f"K8 {name}: {fn.__name__}'s gradients differ from the plain version's")
            line += "; backward of both entries equal to the plain composition's gradient"
        if name == "odd":
            log(line)
            continue
        ms = cuda_ms(lambda: k8.fused_attention(qs, k, v, mn, mx, 8), 10)
        packed_ms = cuda_ms(lambda: k8.fused_attention_packed(*views, mn, mx, 8), 10)
        plain_ms, lo, hi = median_ms(lambda: k8.fused_attention_ref(qs, k, v, mn, mx, 8), ATTN_PLAIN_REPS)
        lib_ms = cuda_ms(lambda: fq.act_fake_quant(F.scaled_dot_product_attention(qs, k, v, scale=1.0), mn, mx, 8),
                         10)
        moved, ops = attention_bound(bh, lq, lk, d)
        b, tb, rb = bound_of(moved, ops, F32_OPS_S), route_bound(moved, ops), attention_route_bound(moved, ops)
        log(f"{line}; kernel {ms:.4f} ms, packed entry {packed_ms:.4f} ms ({b['bound_ms'] / packed_ms:.1%} of its "
            f"{b['bound_ms']:.4f} ms float32 bound by {b['bound_by']}, {tb['route_bound_ms'] / packed_ms:.1%} of the "
            f"3xTF32 bound {tb['route_bound_ms']:.4f} ms by {tb['route_bound_by']}, {rb['route_bound_ms'] / packed_ms:.1%}"
            f" of its route's {rb['route_bound_ms']:.4f} ms by {rb['route_bound_by']}), plain {plain_ms:.4f} ms "
            f"(median of {ATTN_PLAIN_REPS}, {lo:.4f}-{hi:.4f}), scaled_dot_product_attention + K1 {lib_ms:.4f} ms; "
            f"{per_forward} launches a {model} forward")
        # the module calls the packed entry: its time is the forward's
        for key, val in zip(keys, (packed_ms, plain_ms, lib_ms, moved, ops)):
            sums[model][key] += per_forward * val
        launches[model] += per_forward
        del qs, k, v, views, ref, heads, got, packed, packed_got, plain, truth, rounded, diff
        torch.cuda.empty_cache()
    for model, t in sums.items():
        b, tb = bound_of(t["moved"], t["ops"], F32_OPS_S), route_bound(t["moved"], t["ops"])
        rb = attention_route_bound(t["moved"], t["ops"])
        log(f"[{phase}] one {model} forward's {launches[model]} K8 launches: {t['ms']:.3f} ms against a "
            f"{b['bound_ms']:.3f} ms float32 bound by {b['bound_by']} ({b['bound_ms'] / t['ms']:.1%}), the 3xTF32 "
            f"bound {tb['route_bound_ms']:.3f} ms ({tb['route_bound_ms'] / t['ms']:.1%}) and its route's "
            f"{rb['route_bound_ms']:.3f} ms ({rb['route_bound_ms'] / t['ms']:.1%}), plain "
            f"{t['plain_ms']:.2f} ms, scaled_dot_product_attention + K1 {t['library_ms']:.3f} ms")
        if model == models[0]:
            results.update(ms=t["ms"], plain_ms=t["plain_ms"], library_ms=t["library_ms"], **b, **rb)
        else:
            prefix = f"{model.lower()}_"
            results.update({f"{prefix}ms": t["ms"], f"{prefix}plain_ms": t["plain_ms"],
                            f"{prefix}library_ms": t["library_ms"], f"{prefix}bound_ms": b["bound_ms"],
                            f"{prefix}route_bound_ms": rb["route_bound_ms"], f"{prefix}launches": launches[model]})
    return results


def build_served_sepformer(dev, mix: np.ndarray, steps: int = SEP_OBSERVE_STEPS) -> Sepformer:
    """The full-width Sepformer from ``create_pretrained_model``; ranges from ``steps`` observer steps on ``mix``."""
    cfg = {**SEPFORMER_CFG, "quantization": {**SEPFORMER_CFG["quantization"], "max_observations": steps}}
    observer = create_pretrained_model(cfg, observer=True, device=dev).train()
    x = torch.from_numpy(mix).to(dev)
    with torch.no_grad():
        for _ in range(steps):
            observer(x)
    served = create_pretrained_model(SEPFORMER_CFG, observer=False, device=dev)
    served.load_state_dict(observer.state_dict())
    return served


def sepformer_int8_sites(model: Sepformer) -> int:
    """The Sepformer int8 engine's K4 launches: four a transformer layer (the in-projection in one, its
    out-projection, the two feed-forward linears) and the masker's bottleneck, Conv2d and end conv."""
    return 4 * sum(isinstance(m, TransformerLayer) for m in model.modules()) + 3


def sepformer_int8_cases(sep: Sepformer) -> list[tuple]:
    """(M, K, N, nl, alpha, grids, what, launches per forward) of the Sepformer int8 engine's K4 launches at
    SEP_BATCH x SEP_SEG: every transformer layer's in-projection (three output grids), out-projection and two
    feed-forward linears, the masker's bottleneck, Conv2d and end conv (ReLU)."""
    frames = (SEP_SEG - sep.encoder.conv.weight.shape[-1]) // sep.encoder.conv.stride + 1
    (_, _, k, *_), (_, _, s, *_) = sepformer_attention_shapes(sep)
    tokens, f = SEP_BATCH * k * s, sep.n_filters
    n_ffn = sep.masker.blocks[0].intra_transformer_block.layers[0].ffn_in.weight.shape[0]
    layers = sum(isinstance(m, TransformerLayer) for m in sep.modules())
    one = (INT8_TIE_DELTA, INT8_TIE_MN)
    return [(tokens, f, 3 * f, "prelu", 1.0, QKV_GRIDS, "in-projection (three output grids)", layers),
            (tokens, f, f, "prelu", 1.0, one, "out-projection", layers),
            (tokens, f, n_ffn, "prelu", 1.0, one, "ffn_in", layers),
            (tokens, n_ffn, f, "prelu", 1.0, one, "ffn_out", layers),
            (SEP_BATCH * frames, f, f, "prelu", 1.0, one, "bottleneck", 1),
            (tokens, f, sep.n_srcs * f, "prelu", 1.0, one, "conv2d", 1),
            (SEP_BATCH * sep.n_srcs * frames, f, f, "prelu", 0.0, one, "end_conv (ReLU)", 1)]


def serve_sepformer(dev, smi: str, dpt_attn_shapes: list[tuple]) -> tuple:
    """Phases 24-30: K8 at every attention shape, then the Sepformer serving path. Returns (K8 results, the
    launches of phase 25's forward, its K3 shapes for phase 37, the served weights and ranges, K4's time and bound
    per Sepformer int8 forward)."""
    smix, _ = synth_batch(np.random.default_rng(25), SEP_BATCH, 2, SEP_SEG)
    t0 = time.perf_counter()
    sep = build_served_sepformer(dev, smix[:2])
    calib_s = time.perf_counter() - t0
    shapes = sepformer_attention_shapes(sep)
    attn = check_attention_kernel(dev, [*shapes, *dpt_attn_shapes])  # 24.
    torch.cuda.empty_cache()

    # 25. the full-width forward
    counts = count_quantizers(sep.modules())
    n_mha = sum(isinstance(m, QMultiheadAttention) for m in sep.modules())
    n_params = sum(p.numel() for n, p in sep.named_parameters() if "fake_quantize" not in n)
    x = torch.from_numpy(smix).to(dev)
    k3_shapes, hooks = record_k3_inputs(sep, "Sepformer masker conv1d")
    reset_all_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        y = sep(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = all_launches()
    for h in hooks:
        h.remove()
    # every act quantizer but the attention's two no-op sites and its head grid (in K8's epilogue), the QDense
    # layers' (in K5) and the masker conv1d's (in K3)
    dense, fused = dense_quantizers(sep), fused_convs(sep)
    want = no_launches(act=counts["act"] - 3 * n_mha - dense["act"] - fused["act"], weight=1, attention=n_mha,
                       dense=dense["dense"], qmatmul=fused["qmatmul"])
    if tuple(y.shape) != (SEP_BATCH, 2, SEP_SEG) or not torch.isfinite(y).all():
        raise AssertionError(f"Sepformer forward gave shape {tuple(y.shape)}, finite={bool(torch.isfinite(y).all())}")
    if launches != want:
        raise AssertionError(f"Sepformer launches {launches} != {want}")
    log(f"[25] full-width Sepformer {tuple(x.shape)} -> {tuple(y.shape)}, finite, {n_params} parameters, "
        f"{', '.join(f'{n} BH {bh} x L {lq}' for n, bh, lq, *_ in shapes)}, d {shapes[0][4]}; ranges from "
        f"{SEP_OBSERVE_STEPS} observer steps on 2 x {SEP_SEG // SR} s in {calib_s:.1f} s; first call {first_s:.2f} s; "
        f"launches act={launches['act']} (= {counts['act']} act quantizers - {3 * n_mha} no-op sites and head grids of "
        f"{n_mha} attentions - {dense['act']} in K5 - {fused['act']} in K3) weight={launches['weight']} (the "
        f"{counts['weight']} weight quantizers grouped; K5's {dense['weight']} and K3's {fused['weight']} weight "
        f"grids off) attention={launches['attention']} dense={launches['dense']} (= QDense layers and the attentions' projections) "
        f"qmatmul={launches['qmatmul']} (= the masker's conv1d, K3: {k3_shapes})")

    # 26. card vs CPU on the same weights, quantized and float
    cpu_sep = create_pretrained_model(SEPFORMER_CFG, observer=False)
    cpu_sep.load_state_dict(sep.state_dict())
    x1 = torch.from_numpy(smix[:1, :SR])
    with torch.inference_mode():
        y_card = sep(x1.to(dev)).cpu()
        y_cpu = cpu_sep(x1)
    snr = snr_db(y_cpu, y_card)
    lsb = out_step(sep)
    floor = (snr.min().item(), (y_card - y_cpu).abs().mean().item() / lsb)
    weights = {k: v for k, v in sep.state_dict().items() if "quantiz" not in k}
    floats = []
    for device in (dev, torch.device("cpu")):  # no quantizers: the float model on the same weights
        m = create_model(SEPFORMER_CFG, QuantSpec(n_splitter=2, n_combiner=2, train_res_dec=True))
        m.load_state_dict(weights)
        with torch.inference_mode():
            floats.append(m.to(device).eval()(x1.to(device)).cpu())
    snr_float = snr_db(floats[1], floats[0])
    log(f"[26] Sepformer card vs CPU at 1 x {SR}: SNR {[round(v, 2) for v in snr.flatten().tolist()]} dB "
        f"(>= {SEP_CARD_VS_CPU_DB}), {(y_card != y_cpu).float().mean().item():.4f} of samples differ, mean "
        f"{floor[1]:.4f} output steps, output rms {y_cpu.pow(2).mean().sqrt().item() / lsb:.2f} steps; the float "
        f"model on the same weights {[round(v, 2) for v in snr_float.flatten().tolist()]} dB "
        f"(>= {SEP_FLOAT_CARD_VS_CPU_DB})")
    if not bool((snr >= SEP_CARD_VS_CPU_DB).all()) or not bool((snr_float >= SEP_FLOAT_CARD_VS_CPU_DB).all()):
        raise AssertionError(f"Sepformer card vs CPU SNR {snr.tolist()} dB (minimum {SEP_CARD_VS_CPU_DB}), float "
                             f"{snr_float.tolist()} dB (minimum {SEP_FLOAT_CARD_VS_CPU_DB})")
    del floats

    # 27. the folded engine
    folded = fold_quantized_weights(sep)
    reset_all_launches()
    with torch.inference_mode():
        y_folded = folded(x)
    torch.cuda.synchronize()
    if (fq.LAUNCHES["weight"] != 0 or k8.LAUNCHES["attention"] != n_mha or qd.LAUNCHES["dense"] != dense["dense"]
            or qm.LAUNCHES["qmatmul"] != fused["qmatmul"]):
        raise AssertionError(f"the folded Sepformer launched {all_launches()}")
    if not torch.equal(y_folded, y):
        raise AssertionError(f"folded Sepformer != fake-quant, max abs diff {(y_folded - y).abs().max().item()}")
    log(f"[27] folded Sepformer: bitwise equal to fake-quant; act launches {fq.LAUNCHES['act']}, weight 0 (the "
        f"residual decoder folded too), attention {k8.LAUNCHES['attention']}, dense {qd.LAUNCHES['dense']} and "
        f"qmatmul {qm.LAUNCHES['qmatmul']} (K5 and K3 with the weight grid off)")
    del y_folded
    torch.cuda.empty_cache()

    # 28. requests through the infer entry
    for i, sec in enumerate(serve_requests(dev, sep.state_dict(), SEPFORMER_CFG)):
        log(f"[28] Sepformer request {i} (folded): 20 s mixture -> 2 sources of 20 s, {sec * 1000:.1f} ms")

    # 29. K4 at the int8 engine's shapes, then the engine (launch counts set to 0 inside, read after each forward)
    int8_cases = sepformer_int8_cases(sep)
    if sum(c[-1] for c in int8_cases) != sepformer_int8_sites(sep):
        raise AssertionError(f"phase 29's K4 cases count {sum(c[-1] for c in int8_cases)} launches a forward, the "
                             f"engine {sepformer_int8_sites(sep)}")
    k4 = check_int8_cases(dev, 29, "Sepformer", int8_cases, 29)
    engines = int8_engines_vs_fake_quant(29, "Sepformer", sep, cpu_sep, x, y, floor,
                                         no_launches(int8_mm=sepformer_int8_sites(sep)), SEP_INT8_CARD_VS_CPU_DB)

    # 30. throughput
    audio_s = SEP_BATCH * SEP_SEG / SR
    for name, fn in (("fake_quant", sep), ("folded", folded), *((f"int8 {d}", e) for d, e in engines.items())):
        with torch.inference_mode():
            ms = cuda_ms(lambda: fn(x), 3)
        log(f"[30] Sepformer throughput {name}: {audio_s / (ms / 1000):.1f} sec-audio/s ({ms:.1f} ms per forward of "
            f"{SEP_BATCH} x {SEP_SEG // SR} s) on {smi}")
    return attn, launches, k3_shapes, state_on_cpu(sep), k4


def dense_train_shapes(dpt_seg: int, sep_seg: int) -> list[tuple]:
    """(name, M, K, N, launches per student forward, grids) of K5's launches in the full-width DPTNet and Sepformer
    at the training batch (1 x dpt_seg and 1 x sep_seg samples), recomputed from the models: the QDense layers
    (``grids`` True: their weight and act grids) and the self-attentions' in- and out-projections (False: K5's
    core with both grids off, the bias in the epilogue)."""
    dpt, sep = create_model(DPTNET_CFG, QuantSpec()), create_model(SEPFORMER_CFG, QuantSpec())
    segs, _ = split_segments(torch.empty(1, dpt_seg - dpt.kernel_size + 1, 1), dpt.separator.segment_size)
    dpt_tokens = segs.shape[1] * segs.shape[2]
    layer = dpt.separator.DPT.rows[0]
    out_conv = dpt.separator.DPT.out_conv
    frames = (sep_seg - sep.encoder.conv.weight.shape[-1]) // sep.encoder.conv.stride + 1
    segs, _ = split_segments(torch.empty(1, frames, 1), sep.masker.chunk_size)
    sep_tokens = segs.shape[1] * segs.shape[2]
    ffn = sep.masker.blocks[0].intra_transformer_block.layers[0]
    n_layers = sum(isinstance(m, TransformerLayer) for m in sep.modules())
    shapes = [("DPTNet linear", dpt_tokens, *layer.linear.weight.shape[::-1], 2 * dpt.layer, True),
              ("DPTNet out_conv", dpt_tokens, *out_conv.weight.shape[::-1], 1, True),
              ("Sepformer ffn_in", sep_tokens, *ffn.ffn_in.weight.shape[::-1], n_layers, True),
              ("Sepformer ffn_out", sep_tokens, *ffn.ffn_out.weight.shape[::-1], n_layers, True),
              ("Sepformer conv2d", sep_tokens, *sep.masker.conv2d.weight.shape[::-1], 1, True)]
    for model, tokens in ((dpt, dpt_tokens), (sep, sep_tokens)):
        mhas = [m for m in model.modules() if isinstance(m, QMultiheadAttention)]
        name = type(model).__name__
        shapes += [(f"{name} in-projection", tokens, *mhas[0].in_proj_weight.shape[::-1], len(mhas), False),
                   (f"{name} out-projection", tokens, *mhas[0].out_proj_weight.shape[::-1], len(mhas), False)]
    n_dense = sum(isinstance(m, QDense) for model in (dpt, sep) for m in model.modules())
    n_mha = sum(isinstance(m, QMultiheadAttention) for model in (dpt, sep) for m in model.modules())
    if sum(s[4] for s in shapes) != n_dense + 2 * n_mha:
        raise AssertionError(f"the K5 shapes {shapes} do not cover the models' QDense layers and projections")
    return shapes


def dense_case(dev, m: int, k: int, n: int, gen: torch.Generator) -> tuple:
    """x [m, k], w [n, k] (unit-variance products), b, weight and act ranges; output channel 0 carries planted
    ties: a weight grid of step TIE_STEP, w[0, 0] = 5 steps, b[0] half a step above the act grid's mn (step
    TIE_STEP); rows 0-5 take x[r, 0] alone (r + 1, and 0 for row 5): pre = mn + (5 (r + 1) + 0.5) steps, exact
    half-step ties, and row 5's on the grid's lower clip bound; row 6 is far past both clip bounds."""
    x = torch.randn(m, k, device=dev, generator=gen)
    w = torch.randn(n, k, device=dev, generator=gen) / math.sqrt(k)
    b = torch.randn(n, device=dev, generator=gen) * 0.1
    w_mn, w_mx = w.amin(1, keepdim=True), w.amax(1, keepdim=True)
    a_mn, a_mx = torch.tensor([-1.0], device=dev), torch.tensor([-1.0 + 255 * TIE_STEP], device=dev)
    w_mn[0], w_mx[0] = -255 / 256, 255 / 256
    w[0, 0], b[0] = 5 * TIE_STEP, -1.0 + 0.5 * TIE_STEP
    rows = min(m, 6)
    x[:rows] = 0
    x[:rows, 0] = torch.tensor([1.0, 2, 3, 4, 5, 0], device=dev)[:rows]
    if m > 6:
        x[6] = 50.0 * torch.sign(x[6])
    return x, w, b, w_mn, w_mx, a_mn, a_mx


def dense_args(case: tuple, flags: dict) -> tuple:
    """qat_dense's arguments for a case with the grids and observing flags of ``flags``."""
    x, w, b, w_mn, w_mx, a_mn, a_mx = case
    flag = (lambda v: None if v is None else torch.tensor(v, device=x.device))
    on_w, on_a = flags.get("w", True), flags.get("a", True)
    return (x, w, b, w_mn if on_w else None, w_mx if on_w else None, a_mn if on_a else None, a_mx if on_a else None,
            8, 8, flag(flags.get("w_obs")), flag(flags.get("a_obs")))


def check_dense_forward(name: str, args: tuple, bf16: bool = False, gelu: bool = False) -> float:
    """K5 (``bf16``: its bf16 route; ``gelu``: its GELU route, the bound GELU_SLOPE times larger) against its plain
    version (module note of DENSE_RTOL), two runs bitwise equal; returns the largest |pre - plain| / bound."""
    x, w, b, w_mn, w_mx, a_mn, a_mx, _, _, w_obs, a_obs = args
    y = qd.qat_dense(*args, bf16=bf16, gelu=gelu)
    if not torch.equal(qd.qat_dense(*args, bf16=bf16, gelu=gelu), y):
        raise AssertionError(f"K5 {name}: two runs differ")
    pre = qd.qat_dense(x, w, b, w_mn, w_mx, None, None, 8, 8, w_obs, None, bf16=bf16, gelu=gelu)
    xr, wq = qd.operands(x, qd._weight_q(w, w_mn, w_mx, 8, w_obs), bf16)
    bound = (xr.abs() @ wq.abs().t() + b.abs()) * (GELU_SLOPE if gelu else 1.0)
    plain = qd.qat_dense_ref(x, w, b, w_mn, w_mx, None, None, 8, 8, w_obs, None, bf16=bf16, gelu=gelu)
    err = ((pre - plain).abs() / bound).max().item()
    if not err <= DENSE_RTOL:
        raise AssertionError(f"K5 {name}: pre-activation {err:.3g} of sum |term| from the plain version's")
    if a_mn is None or (a_obs is not None and bool(a_obs)):
        if not torch.equal(y, pre):
            raise AssertionError(f"K5 {name}: with the act grid off the output is not the pre-activation")
        return err
    if not torch.equal(y, fq.act_fake_quant_ref(pre, a_mn, a_mx, 8)):
        raise AssertionError(f"K5 {name}: the epilogue is not K1's plain grid of the kernel's own pre-activation")
    step = (a_mx - a_mn).item() / 255
    diff = (y - qd.qat_dense_ref(*args, bf16=bf16, gelu=gelu)).abs()
    share = (diff > 0.5 * step).float().mean().item()
    if diff.max().item() > step * (1 + 1e-4) or share > DENSE_GRID_SHARE:
        raise AssertionError(f"K5 {name}: {diff.max().item() / step:.3f} steps from the plain version, {share:.2e} "
                             f"of the outputs a step apart (at most {DENSE_GRID_SHARE})")
    return err


def check_dense_backward(name: str, args: tuple, g: torch.Tensor, gelu: bool = False) -> float:
    """K5-bwd against the plain backward at the kernel's own pre-activation (so at the same act mask): dx, dw and
    db within DENSE_RTOL of their terms' magnitudes, the act ranges' gradients within SUM_RTOL of sum |term|, the
    weight ranges' within 2 DENSE_RTOL of the magnitudes through the grid; the plain version's own pre-activation
    flips at most DENSE_GRID_SHARE of the masks. Two runs are bitwise equal, and the mask pass's gm is g times
    the mask of the forward kernel's own pre-activation, exactly. ``gelu``: the GELU route's backward, the act
    terms at gelu(pre), the bounds GELU_SLOPE times larger (|gelu'| <= GELU_SLOPE), and gm = g mask gelu'(pre)
    within 2^-21 of its magnitude (CUDA's erfcf and expf in both, the products in one order). Returns the largest
    error relative to its bound."""
    x, w, b, w_mn, w_mx, a_mn, a_mx, _, _, w_obs, a_obs = args
    got = qd.qat_dense_bwd(x, w, b, g, *args[3:], gelu=gelu)
    for a, b_ in zip(got, qd.qat_dense_bwd(x, w, b, g, *args[3:], gelu=gelu)):
        if a is not None and not torch.equal(a, b_):
            raise AssertionError(f"K5-bwd {name}: two runs differ")
    pre = qd.qat_dense(x, w, b, w_mn, w_mx, None, None, 8, 8, w_obs, None)
    act_in = gelu_ref if gelu else (lambda v: v)
    grid_on = a_mn is not None and not (a_obs is not None and bool(a_obs))
    if grid_on or gelu:
        gm = qd.mask_pass(x, w, b, g, w_mn, w_mx, a_mn, a_mx, 8, 8, w_obs, a_obs, 1.0, gelu)[0]
        want_gm = fq.act_bwd_terms(act_in(pre), g, a_mn, a_mx, 8, 1.0)[0] if grid_on else g
        if gelu:
            want_gm = want_gm * gelu_grad(pre)
            if bool(((gm - want_gm).abs() > 2.0**-21 * want_gm.abs()).any()):
                raise AssertionError(f"K5-bwd {name}: the GELU mask pass's gm is not g mask gelu'(pre)")
        elif not torch.equal(gm, want_gm):
            raise AssertionError(f"K5-bwd {name}: the mask pass's pre-activation is not the forward's")
    want = qd.qat_dense_bwd_ref(x, w, b, g, *args[3:], pre=pre, gelu=gelu)
    wq = qd._weight_q(w, w_mn, w_mx, 8, w_obs)
    absg = g.abs() * (GELU_SLOPE if gelu else 1.0)
    a_prod = absg.t() @ x.abs()
    worst = 0.0
    for what, a, b_, bound in (("dx", got[0], want[0], absg @ wq.abs()), ("dw", got[1], want[1], a_prod),
                               ("db", got[2], want[2], absg.sum(0))):
        err = ((a - b_).abs() / (DENSE_RTOL * bound).clamp_min(1e-30)).max().item()
        if not err <= 1.0:
            raise AssertionError(f"K5-bwd {name} {what}: {err:.3g} times its bound from the plain version")
        worst = max(worst, err * DENSE_RTOL)
    if grid_on:
        _, p_mn, p_mx = fq.act_bwd_terms(act_in(pre), g, a_mn, a_mx, 8, 1.0)
        for got_r, terms in ((got[5], p_mn), (got[6], p_mx)):
            worst = max(worst, check_sum(f"K5-bwd {name} act range", got_r, terms.double().sum(),
                                         terms.double().abs().sum()) / terms.double().abs().sum().item())
        flips = (fq.act_bwd_terms(act_in(pre), g, a_mn, a_mx, 8, 1.0)[0] != fq.act_bwd_terms(
            act_in(qd.qat_dense_ref(x, w, b, w_mn, w_mx, None, None, 8, 8, w_obs, None)), g, a_mn, a_mx, 8, 1.0)[0])
        if flips.float().mean().item() > DENSE_GRID_SHARE:
            raise AssertionError(f"K5-bwd {name}: {flips.float().mean().item():.2e} of the act masks flip")
    if w_mn is not None:
        _, terms = fq.weight_bwd_terms(w, a_prod, w_mn, w_mx, 8, 0)
        bound = fq.route_range_grad(terms.double().abs().sum(1), w_mn.double(), w_mx.double(), 8, 1.0)
        for got_r, want_r, b_r in zip(got[3:5], want[3:5], bound):
            if bool(((got_r.double() - want_r.double()).abs() > 2 * DENSE_RTOL * b_r.abs() + 1e-30).any()):
                raise AssertionError(f"K5-bwd {name}: a weight range gradient beyond its bound")
    return worst


def rate_and_shares(nbytes: float, ops: float, ms: float) -> str:
    """A qat_dense kernel's achieved rate and its time's share against the float32 CUDA-core bound and against
    its route's (3xTF32) bound."""
    f32, route = bound_of(nbytes, ops, F32_OPS_S), route_bound(nbytes, ops)
    return (f"{ops / ms / 1e9:.1f} TFLOP/s; {f32['bound_ms'] / ms:.1%} of its {f32['bound_ms']:.4f} ms float32 "
            f"bound by {f32['bound_by']}, {route['route_bound_ms'] / ms:.1%} of its {route['route_bound_ms']:.4f} ms "
            f"3xTF32 bound by {route['route_bound_by']}")


def dense_bounds(m: int, k: int, n: int, grids: bool = True) -> tuple[tuple[int, int], tuple[int, int]]:
    """(bytes, operations) of K5 (x, w, b, ranges in, y out; the product) and of K5-bwd (x, w, b, g, ranges in,
    dx, dw, db out; the pre-activation where ``grids`` (the act grid's mask needs it), dx and dwq products),
    float32."""
    fwd = 4 * (m * k + n * k + n + 2 * n + 2 + m * n), 2 * m * n * k
    bwd = 4 * (2 * m * k + 2 * n * k + 2 * n + m * n + 2 * n + 2), (6 if grids else 4) * m * n * k
    return fwd, bwd


def check_dense_kernels(dev, shapes: list[tuple]) -> tuple[dict, dict]:
    """Phase 31: K5 and K5-bwd against their plain versions at the training path's shapes and odd ones; their
    times per student forward (one DPTNet and one Sepformer train step's QDense launches)."""
    gen = torch.Generator(device=dev).manual_seed(31)
    fwd = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    bwd = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    totals = {"fwd": [0, 0], "bwd": [0, 0]}
    for name, m, k, n, per_forward, grids in [*shapes, *(("odd", *s, 0, True) for s in DENSE_ODD)]:
        case = dense_case(dev, m, k, n, gen)
        g = torch.randn(m, n, device=dev, generator=gen)
        for flags in DENSE_FLAGS:
            args = dense_args(case, flags)
            fwd["max_abs_err"] = max(fwd["max_abs_err"], check_dense_forward(f"{name} {flags}", args))
            bwd["max_abs_err"] = max(bwd["max_abs_err"], check_dense_backward(f"{name} {flags}", args, g))
        line = (f"[31] K5 {name} [{m},{k}] x [{n},{k}]: every grid and observing-flag combination "
                f"({len(DENSE_FLAGS)}) within its bounds, planted ties and clip extremes included")
        if per_forward == 0:
            log(line)
            continue
        x, w, b, w_mn, w_mx, a_mn, a_mx = case
        if not grids:  # a projection: both grids off, timed as the layer runs it
            w_mn = w_mx = a_mn = a_mx = None
        wq = fq.weight_fake_quant(w, w_mn, w_mx, 8, 0) if grids else w
        pre = torch.addmm(b, x, wq.t())
        times = {
            "fwd": cuda_ms(lambda: qd.qat_dense(x, w, b, w_mn, w_mx, a_mn, a_mx), 10),
            "fwd_plain": cuda_ms(lambda: qd.qat_dense_ref(x, w, b, w_mn, w_mx, a_mn, a_mx), 10),
            "fwd_library": cuda_ms(lambda: fq.act_fake_quant(torch.addmm(b, x, wq.t()), a_mn, a_mx, 8) if grids
                                   else torch.addmm(b, x, w.t()), 10),
            "bwd": cuda_ms(lambda: qd.qat_dense_bwd(x, w, b, g, w_mn, w_mx, a_mn, a_mx), 10),
            "bwd_plain": cuda_ms(lambda: qd.qat_dense_bwd_ref(x, w, b, g, w_mn, w_mx, a_mn, a_mx), 10),
            "bwd_library": cuda_ms(lambda: (g @ wq, g.t() @ x, fq.act_fake_quant_bwd(pre, g, a_mn, a_mx, 8) if grids
                                            else g.sum(0)), 10),
        }
        (fb, fo), (bb, bo) = dense_bounds(m, k, n, grids)
        log(f"{line}; timed with {'both grids on' if grids else 'both grids off'}: K5 {times['fwd']:.4f} ms "
            f"({rate_and_shares(fb, fo, times['fwd'])}), plain {times['fwd_plain']:.4f}, addmm"
            f"{' + K1' if grids else ''} {times['fwd_library']:.4f}; K5-bwd {times['bwd']:.4f} ms "
            f"({rate_and_shares(bb, bo, times['bwd'])}), plain {times['bwd_plain']:.4f}, two mm + "
            f"{'K1-bwd' if grids else 'the bias sum'} {times['bwd_library']:.4f}; {per_forward} a forward")
        for key, res in (("fwd", fwd), ("bwd", bwd)):
            res["ms"] += per_forward * times[key]
            res["plain_ms"] += per_forward * times[f"{key}_plain"]
            res["library_ms"] += per_forward * times[f"{key}_library"]
        totals["fwd"] = [totals["fwd"][0] + per_forward * fb, totals["fwd"][1] + per_forward * fo]
        totals["bwd"] = [totals["bwd"][0] + per_forward * bb, totals["bwd"][1] + per_forward * bo]
        del case, g, x, w, wq, pre
        torch.cuda.empty_cache()
    fwd.update(bound_of(*totals["fwd"], F32_OPS_S), **route_bound(*totals["fwd"]))
    bwd.update(bound_of(*totals["bwd"], F32_OPS_S), **route_bound(*totals["bwd"]))
    # The Sepformer's serving shape, 8 x 4 s (68,000 tokens): what PERF.md's prediction for K5 was made at.
    for m, k, n in ((SEP_BATCH * shapes[2][1], *shapes[2][2:4]), (SEP_BATCH * shapes[3][1], *shapes[3][2:4])):
        x, w, b, w_mn, w_mx, a_mn, a_mx = dense_case(dev, m, k, n, gen)
        wq = fq.weight_fake_quant(w, w_mn, w_mx, 8, 0)
        ms = cuda_ms(lambda: qd.qat_dense(x, w, b, w_mn, w_mx, a_mn, a_mx), 10)
        lib = cuda_ms(lambda: fq.act_fake_quant(torch.addmm(b, x, wq.t()), a_mn, a_mx, 8), 10)
        log(f"[31] K5 at the Sepformer's 8 x 4 s shape [{m},{k}] x [{n},{k}]: {ms:.4f} ms "
            f"({rate_and_shares(*dense_bounds(m, k, n)[0], ms)}), addmm + K1 {lib:.4f} ms")
        del x, w, wq
    log(f"[31] one DPTNet and one Sepformer student forward's {sum(s[4] for s in shapes)} K5 launches at the "
        f"training batch: {fwd['ms']:.3f} ms ({rate_and_shares(*totals['fwd'], fwd['ms'])}), plain "
        f"{fwd['plain_ms']:.3f}, addmm + K1 {fwd['library_ms']:.3f}; their K5-bwd {bwd['ms']:.3f} ms "
        f"({rate_and_shares(*totals['bwd'], bwd['ms'])}), plain {bwd['plain_ms']:.3f}, two mm + K1-bwd "
        f"{bwd['library_ms']:.3f}")
    return fwd, bwd


def check_lstm_backward(dev, shapes: list[tuple[str, int, int, int]]) -> None:
    """Phase 32: the K7/K6 wrapper's gradient (the kernel forward, the plain recurrence recomputed in the
    backward) against the plain recurrence's own, at DPTNet's training shapes and LSTM_ODD."""
    gen = torch.Generator(device=dev).manual_seed(32)
    for side, T, B, H in [*shapes, ("odd", *LSTM_ODD)]:
        ih = [torch.randn(T, B, 4 * H, device=dev, generator=gen) * 0.5 for _ in range(3)]
        w = [(torch.rand(H, 4 * H, device=dev, generator=gen) * 2 - 1) / math.sqrt(H) for _ in range(3)]
        g = [torch.randn(T, B, H, device=dev, generator=gen) for _ in range(3)]
        grads = []
        before = dict(lk.LAUNCHES)
        for bi, uni in ((lk.bilstm_sequence, lk.lstm_sequence), (lk.bilstm_sequence_ref, lk.lstm_sequence_ref)):
            t = [a.clone().requires_grad_(True) for a in (*ih, *w)]
            hf, hb = bi(t[0], t[1], t[3], t[4])
            ((hf * g[0]).sum() + (hb * g[1]).sum() + (uni(t[2], t[5]) * g[2]).sum()).backward()
            grads.append([a.grad for a in t])
        torch.cuda.synchronize()
        if lk.LAUNCHES != {**before, "lstm": before["lstm"] + 1, "bilstm": before["bilstm"] + 1}:
            raise AssertionError(f"LSTM backward at {side}: launches {lk.LAUNCHES}, expected one K7 and one K6")
        rel = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(*grads))
        if not rel <= LSTM_GRAD_TOL:
            raise AssertionError(f"LSTM backward at {side} T {T} x B' {B} x H {H}: {rel:.3g} of the gradient's "
                                 f"magnitude from the plain recurrence's (at most {LSTM_GRAD_TOL})")
        log(f"[32] K7/K6 backward {side} T {T} x B' {B} x H {H}: ih and w_hh gradients through the autograd "
            f"wrapper max {rel:.3g} of their magnitude from the plain recurrence's (<= {LSTM_GRAD_TOL}); the "
            f"forward launched K7 and K6 once, the backward nothing")
        del ih, w, g, grads
        torch.cuda.empty_cache()


def train_cfg(cfg: dict) -> dict:
    return {**cfg, "quantization": {**cfg["quantization"], "max_observations": TRAIN_MODELS_WINDOW}}


def train_launches(model, teacher) -> dict:
    """The launches of one KD step: forward, every quantizer module (K5 for the QDense layers' grids, K1 for the
    attention's no-op sites too, which observe in train mode), one grouped launch for every weight quantizer (the
    student's: the teacher is float), K7 and K8 for student and teacher; backward, K5-bwd per QDense, K1-bwd per act
    quantizer whose output reaches the loss (not the no-op sites, run under no_grad), one grouped launch for the
    weight quantizers; K3 for the teacher's bias-free 1x1 convs, which run without gradient (the student's take the
    differentiable composition)."""
    q, dense = count_quantizers(model.modules()), dense_quantizers(model)
    n_mha = sum(isinstance(m, QMultiheadAttention) for m in model.modules())
    bilstm = sum(isinstance(m, QLSTM) for net in (model, teacher) for m in net.modules())
    return no_launches(act=q["act"] - dense["act"], weight=1, act_bwd=q["act"] - dense["act"] - 2 * n_mha,
                       weight_bwd=1, bilstm=bilstm,
                       attention=sum(isinstance(m, QMultiheadAttention) for net in (model, teacher)
                                     for m in net.modules()),
                       dense=dense["dense"] + dense_quantizers(teacher)["dense"], dense_mask=dense["dense"],
                       dense_dx=dense["dense"], dense_dwq=dense["dense"], qmatmul=fused_convs(teacher)["qmatmul"])


def train_model_at_full_width(dev, name: str, cfg: dict, seg: int) -> tuple[TrainState, dict]:
    """Phase 33: KD train steps of 1 x seg samples through an observer window of TRAIN_MODELS_WINDOW steps; every
    step's launches as train_launches says. Returns the state and the run's launch counts."""
    model, teacher = create_model_and_teacher(train_cfg(cfg), generator=torch.Generator().manual_seed(33))
    state = new_train_state(model.to(dev), teacher.to(dev))
    step = make_train_step(TrainConfig())
    want = train_launches(model, teacher)
    rng = np.random.default_rng(33)
    batches = [synth_batch(rng, 1, 2, seg) for _ in range(TRAIN_STEPS)]
    losses = []
    reset_all_launches()
    t0 = time.perf_counter()
    for i, (mix, src) in enumerate(batches):
        before = all_launches()
        metrics = step(state, torch.from_numpy(mix).to(dev), torch.from_numpy(src).to(dev))
        got = {k: v - before[k] for k, v in all_launches().items()}
        if got != want:
            raise AssertionError(f"{name} train step {i}: launches {got} != {want}")
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_launches()
    if not np.isfinite(losses).all() or state.skipped:
        raise AssertionError(f"{name} losses {losses}, skipped {state.skipped}")
    log(f"[33] {name} KD train at full width, {TRAIN_STEPS} steps of 1 x {seg // SR} s, observer window "
        f"{TRAIN_MODELS_WINDOW}, in {seconds:.1f} s: losses {[round(v, 3) for v in losses]} dB, finite, skipped 0; "
        f"every step launched {', '.join(f'{k}={v}' for k, v in want.items() if v)} (student and teacher), all "
        f"others 0")
    return state, launches


def float_version(cfg: dict, model) -> torch.nn.Module:
    """The model without quantizers on the same weights (splitter and combiner planes kept)."""
    q = model.q
    net = create_model(cfg, QuantSpec(n_splitter=q.n_splitter, n_combiner=q.n_combiner, train_res_dec=q.train_res_dec))
    net.load_state_dict({k: v for k, v in model.state_dict().items() if "quantiz" not in k and ".wq_" not in k})
    return net


def train_card_vs_cpu(dev, name: str, cfg: dict, state: TrainState) -> None:
    """Phase 34: one post-window KD step from the same state on the card and on the CPU at 1 x 1 s, for the
    quantized model and for its float version; loss and whole-gradient cosine within TRAIN_CARD_VS_CPU."""
    mix, src = synth_batch(np.random.default_rng(34), 1, 2, SR)
    results = {}
    for version in ("float", "quantized"):
        out = []
        for device in (dev, torch.device("cpu")):
            model = copy.deepcopy(state.model) if version == "quantized" else float_version(cfg, state.model)
            st = new_train_state(model.to(device), copy.deepcopy(state.teacher).to(device))
            metrics = make_train_step(TrainConfig())(st, torch.from_numpy(mix).to(device),
                                                     torch.from_numpy(src).to(device))
            grads = torch.cat([p.grad.flatten().double().cpu() for p in st.model.parameters() if p.grad is not None])
            out.append((float(metrics["loss"]), grads))
        (loss_card, g_card), (loss_cpu, g_cpu) = out
        results[version] = (abs(loss_card - loss_cpu), float(g_card @ g_cpu / (g_card.norm() * g_cpu.norm())),
                            loss_card, loss_cpu, g_card.numel())
    for version, (diff, cos, loss_card, loss_cpu, n) in results.items():
        tol, cos_min = TRAIN_CARD_VS_CPU[version]
        log(f"[34] {name} ({version}) card vs CPU train step at 1 x {SR}: loss {loss_card:.5f} vs {loss_cpu:.5f} dB "
            f"(|diff| {diff:.2e} <= {tol}), whole-gradient cosine {cos:.6f} (>= {cos_min}) over {n} values")
    for version, (diff, cos, *_) in results.items():
        tol, cos_min = TRAIN_CARD_VS_CPU[version]
        if not (diff <= tol and cos >= cos_min):
            raise AssertionError(f"{name} ({version}) card vs CPU train step: loss |diff| {diff} dB (at most {tol}), "
                                 f"gradient cosine {cos} (at least {cos_min})")


def train_step_times(dev, name: str, state: TrainState, seg: int, smi: str, reps: int = 3) -> None:
    """Phase 35: ms per KD step (the mean of ``reps`` after a warm-up) and peak device memory at batch 1, then at the
    largest of 2, 4 and 8 that the batch-1 peak says fits in 80% of the card's memory."""
    step = make_train_step(TrainConfig())
    total = torch.cuda.get_device_properties(dev).total_memory
    per_element = None
    for batch in (1, None):
        if batch is None:
            fits = [b for b in (2, 4, 8) if base + b * per_element <= 0.8 * total]
            if not fits:
                log(f"[35] {name}: no batch of 2, 4 or 8 fits ({per_element / 1e9:.2f} GB a batch element)")
                return
            batch = fits[-1]
        mix, src = synth_batch(np.random.default_rng(35), batch, 2, seg)
        x, s = torch.from_numpy(mix).to(dev), torch.from_numpy(src).to(dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(lambda: step(state, x, s), reps)
        peak = torch.cuda.max_memory_allocated(dev)
        per_element = per_element or (peak - base)
        if state.skipped:
            raise AssertionError(f"{name}: {state.skipped} train steps skipped")
        log(f"[35] {name} train step {batch} x {seg // SR} s: {ms:.1f} ms per step, "
            f"{batch * seg / SR / (ms / 1000):.2f} sec-audio trained/s; peak memory {peak / 1e9:.2f} GB "
            f"({(peak - base) / 1e9 / batch:.2f} GB a batch element above the {base / 1e9:.2f} GB held) on {smi}")
        del x, s
        torch.cuda.empty_cache()


def recipe_epoch(name: str, env: str, cfg: dict, seg: float) -> None:
    """Phase 36: one epoch of the speech recipe through ``python -m fqss_tpu_torch.train`` (on the card, its
    default) with the full-width model, on a mini LibriMix that ``make_mini_librimix`` writes; the config is
    written as JSON, which the CLI reads without a YAML parser."""
    with tempfile.TemporaryDirectory() as tmp:
        train_dir, val_dir = make_mini_librimix(os.path.join(tmp, "data"), n_train=2, n_val=1, sample_rate=SR,
                                                seconds=seg)
        conf = {
            "work_dir": os.path.join(tmp, "run"),
            "model_cfg": train_cfg(cfg),
            "dataset_cfg": {"name": "librimix", "task": "sep_clean", "train_dir": train_dir, "valid_dir": val_dir,
                            "sample_rate": SR, "resample": 1.0, "n_src": 2, "segment": seg,
                            "augmentation": {"enable": False}},
            "training_cfg": {"epochs": 1, "batch_size": 1, "half_lr": True, "early_stop": True, "pretrained": None,
                             "seed": 0, "kd_lambda": 0.1,
                             "optim": {"optimizer": "adam", "lr": 0.001, "weight_decay": 0.0}},
            "testing_cfg": {"test_dir": None, "segment_samples": 16000, "overlap": 0.25},
        }
        if env == "speechbrain":
            conf["training_cfg"].update(threshold_byloss=True, threshold=-30.0, use_speedperturb=False)
        path = os.path.join(tmp, f"{name.lower()}.json")
        with open(path, "w") as fh:
            json.dump(conf, fh)
        env_vars = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "fqss_tpu_torch.train", "-env", env, "-y", path], cwd=tmp,
                              env=env_vars, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0 or "Training done" not in proc.stdout:
            raise AssertionError(f"{name} recipe epoch failed ({proc.returncode}):\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        for out in ("best_model.pt", "checkpoints/epoch_0.pt", "history.json"):
            if not os.path.exists(os.path.join(tmp, "run", out)):
                raise AssertionError(f"{name} recipe epoch wrote no {out}")
        with open(os.path.join(tmp, "run", "history.json")) as fh:
            history = json.load(fh)
        if not np.isfinite(history[0]["loss"]):
            raise AssertionError(f"{name} recipe epoch: loss {history[0]['loss']}")
    log(f"[36] python -m fqss_tpu_torch.train -env {env} with {name}'s full-width model_cfg: one epoch of 2 "
        f"mixtures of {seg:g} s and a validation in {seconds:.1f} s (the process included), train loss "
        f"{history[0]['loss']:.3f}, val loss {history[0].get('val_loss', float('nan')):.3f}; "
        f"{proc.stdout.strip().splitlines()[-1]}")


def shallow_dptnet(state: TrainState, layers: int) -> tuple[dict, TrainState]:
    """(the config, the state) of ``state``'s DPTNet student and teacher cut to their first ``layers`` dual-path
    layers: the same weights, ranges and counters, the later layers left out."""
    return shallow_state(DPTNET_CFG, state, layer=layers)


def shallow_state(cfg: dict, state: TrainState, **cut) -> tuple[dict, TrainState]:
    """(the config, the state) of ``state``'s student and teacher cut to the depth ``cut`` gives ``cfg``: the same
    weights, ranges and counters, the later layers left out."""
    cfg = {**train_cfg(cfg), **cut}

    def shallow(model):
        net = create_model(cfg, model.q)
        full = model.state_dict()
        net.load_state_dict({k: full[k] for k in net.state_dict()})
        return net

    return cfg, TrainState(shallow(state.model), None, shallow(state.teacher))


def train_models(dev, smi: str) -> tuple[dict, dict, dict]:
    """Phases 31-36, the DPTNet and Sepformer training path (phase 34 last, on phase 33's states). Returns (K5
    results, K5-bwd results, the launches of phase 33's runs)."""
    shapes = dense_train_shapes(DPT_TRAIN_SEG, SEP_TRAIN_SEG)
    dense_fwd, dense_bwd = check_dense_kernels(dev, shapes)  # 31.
    dpt = create_model(DPTNET_CFG, QuantSpec())
    check_lstm_backward(dev, dpt_lstm_shapes(1, DPT_TRAIN_SEG, dpt))  # 32.
    torch.cuda.empty_cache()
    clock("31-32")
    launches, after_window = {}, {}
    for name, cfg, seg, reps in (("DPTNet", DPTNET_CFG, DPT_TRAIN_SEG, 1),
                                 ("Sepformer", SEPFORMER_CFG, SEP_TRAIN_SEG, 3)):
        state, run = train_model_at_full_width(dev, name, cfg, seg)  # 33.
        launches = {k: launches.get(k, 0) + v for k, v in run.items()}
        after_window[name] = TrainState(copy.deepcopy(state.model).cpu(), None, copy.deepcopy(state.teacher).cpu())
        clock(f"33 {name}")
        train_step_times(dev, name, state, seg, smi, reps)  # 35.
        del state
        torch.cuda.empty_cache()
        clock(f"35 {name}")
    # 36., the two recipes' processes side by side
    side_by_side(lambda: recipe_epoch("DPTNet", "asteroid", DPTNET_CFG, RECIPE_SECONDS),
                 lambda: recipe_epoch("Sepformer", "speechbrain", SEPFORMER_CFG, RECIPE_SECONDS))
    clock("36")
    dpt_cfg, after_window["DPTNet"] = shallow_dptnet(after_window["DPTNet"], DPT_CPU_LAYERS)
    sep_cfg, after_window["Sepformer"] = shallow_state(SEPFORMER_CFG, after_window["Sepformer"], **SEP_CPU_CUT)
    for name, cfg in ((f"DPTNet (its first {DPT_CPU_LAYERS} dual-path layers)", dpt_cfg),
                      (f"Sepformer (its first of {SEPFORMER_CFG.get('n_repeats', 2)} blocks)", sep_cfg)):
        train_card_vs_cpu(dev, name, cfg, after_window[name.split()[0]])  # 34., from phase 33's state
        clock(f"34 {name.split()[0]}")
    return dense_fwd, dense_bwd, launches


def qmatmul_case(dev, b: int, k: int, t: int, n: int, gen: torch.Generator) -> tuple:
    """x [B, K, T], w [N, K] (unit-variance products), weight and act ranges; output channel 0 carries planted
    ties: a weight grid of step TIE_STEP, w[0] = (5 steps, 0, ...), and an act grid of step TIE_STEP whose mn is
    half a step off zero; time steps 0-5 of batch row 0 take x = 1, 2, 3, 4, 5, 0 there, so y = mn + (5 (t + 1)
    + 128.5) steps and mn + 128.5 steps: exact half-step ties; time step 6 is far past both clip bounds."""
    x = torch.randn(b, k, t, device=dev, generator=gen)
    w = torch.randn(n, k, device=dev, generator=gen) / math.sqrt(k)
    w_mn, w_mx = w.amin(1), w.amax(1)
    a_mn = torch.tensor([-128.5 * TIE_STEP], device=dev)
    a_mx = a_mn + 255 * TIE_STEP
    w_mn[0], w_mx[0] = -255 / 256, 255 / 256
    w[0] = 0.0
    w[0, 0] = 5 * TIE_STEP
    steps = min(t, 6)
    x[0, 0, :steps] = torch.tensor([1.0, 2, 3, 4, 5, 0], device=dev)[:steps]
    if t > 6:
        x[0, :, 6] = 100.0 * torch.sign(w[min(1, n - 1)])
    return x, w, w_mn, w_mx, a_mn, a_mx


def check_qmatmul(name: str, case: tuple, flags: dict, bf16: bool = False) -> float:
    """K3 (``bf16``: its bf16 route) against its plain version with the grids and observing flags of ``flags`` (K5's
    rules, QMM_ODD's note), two runs bitwise equal; returns the largest |pre - plain| / sum |term|."""
    x, w, w_mn, w_mx, a_mn, a_mx = case
    flag = (lambda v: None if v is None else torch.tensor(v, device=x.device))
    wr = (w_mn, w_mx) if flags.get("w", True) else (None, None)
    ar = (a_mn, a_mx) if flags.get("a", True) else (None, None)
    w_obs, a_obs = flag(flags.get("w_obs")), flag(flags.get("a_obs"))
    y = qm.qmatmul(x, w, *wr, *ar, 8, 8, w_obs, a_obs, bf16=bf16)
    if not torch.equal(qm.qmatmul(x, w, *wr, *ar, 8, 8, w_obs, a_obs, bf16=bf16), y):
        raise AssertionError(f"K3 {name} {flags}: two runs differ")
    pre = qm.qmatmul(x, w, *wr, None, None, 8, 8, w_obs, None, bf16=bf16)
    xr, wq = qd.operands(x, qd._weight_q(w, *wr, 8, w_obs), bf16)
    bound = wq.abs() @ xr.abs()
    del xr
    err = ((pre - qm.qmatmul_ref(x, w, *wr, None, None, 8, 8, w_obs, None, bf16=bf16)).abs() / bound.clamp_min(1e-30))
    err = err.max().item()
    del bound
    if not err <= DENSE_RTOL:
        raise AssertionError(f"K3 {name} {flags}: float output {err:.3g} of sum |term| from the plain version's")
    if ar[0] is None or (a_obs is not None and bool(a_obs)):
        if not torch.equal(y, pre):
            raise AssertionError(f"K3 {name} {flags}: with the act grid off the output is not the float output")
        return err
    if not torch.equal(y, fq.act_fake_quant_ref(pre, a_mn, a_mx, 8)):
        raise AssertionError(f"K3 {name} {flags}: the epilogue is not K1's plain grid of the kernel's own output")
    ref = qm.qmatmul_ref(x, w, *wr, *ar, 8, 8, w_obs, a_obs, bf16=bf16)
    diff = (y - ref).abs()
    share = (diff > 0.5 * TIE_STEP).float().mean().item()
    if diff.max().item() > TIE_STEP * (1 + 1e-4) or share > DENSE_GRID_SHARE:
        raise AssertionError(f"K3 {name} {flags}: {diff.max().item() / TIE_STEP:.3f} steps from the plain version, "
                             f"{share:.2e} of the outputs a step apart (at most {DENSE_GRID_SHARE})")
    planted = min(x.shape[-1], 7)
    if not torch.equal(y[0, 0, :planted], ref[0, 0, :planted]):
        raise AssertionError(f"K3 {name} {flags}: planted ties or clip extremes differ: {y[0, 0, :planted]} vs "
                             f"{ref[0, 0, :planted]}")
    return err


def qmatmul_bound(b: int, k: int, t: int, n: int) -> tuple[int, int]:
    """(bytes, operations) of K3: x, w and the ranges in, y out; the product, float32."""
    return 4 * (b * k * t + n * k + 2 * n + 2 + b * n * t), 2 * b * n * k * t


def check_qmatmul_kernel(dev, shapes: list[tuple], phase: int = 37,
                         forward: str = "one DPTNet and one Sepformer serving forward's") -> dict:
    """Phase 37 (and 49 at the music shapes): K3 against its plain version at the shapes the serving forwards gave
    it and at odd ones, every grid and observing-flag combination; times of K3, the plain version and
    torch.matmul + K1 per forward, with the bound. A shape is (name, B, K, T, N), launched once a forward, or
    (name, B, K, T, N, launches a forward)."""
    gen = torch.Generator(device=dev).manual_seed(phase)
    res = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "forward_launches": 0}
    total = [0, 0]
    for name, b, k, t, n, *per in [*shapes, *(("odd", *s) for s in QMM_ODD)]:
        case = qmatmul_case(dev, b, k, t, n, gen)
        for flags in DENSE_FLAGS:
            res["max_abs_err"] = max(res["max_abs_err"], check_qmatmul(f"{name} [{b},{k},{t}] -> {n}", case, flags))
        line = (f"[{phase}] K3 {name} [{b},{k},{t}] x [{n},{k}]: every grid and observing-flag combination "
                f"({len(DENSE_FLAGS)}) within its bounds, planted ties and clip extremes exact")
        if name == "odd":
            log(line)
            continue
        launches = per[0] if per else 1
        x, w, w_mn, w_mx, a_mn, a_mx = case
        wq = fq.weight_fake_quant(w, w_mn, w_mx, 8, 0)
        times = {"ms": cuda_ms(lambda: qm.qmatmul(x, w, w_mn, w_mx, a_mn, a_mx), 10),
                 "plain_ms": cuda_ms(lambda: qm.qmatmul_ref(x, w, w_mn, w_mx, a_mn, a_mx), 10),
                 "library_ms": cuda_ms(lambda: fq.act_fake_quant(torch.matmul(wq, x), a_mn, a_mx, 8), 10)}
        nbytes, ops = qmatmul_bound(b, k, t, n)
        log(f"{line}; K3 {times['ms']:.4f} ms ({rate_and_shares(nbytes, ops, times['ms'])}), plain "
            f"{times['plain_ms']:.4f}, torch.matmul + K1 {times['library_ms']:.4f}; {launches} launches a forward")
        for key in ("ms", "plain_ms", "library_ms"):
            res[key] += launches * times[key]
        res["forward_launches"] += launches
        total = [total[0] + launches * nbytes, total[1] + launches * ops]
        del case, x, w, wq
        torch.cuda.empty_cache()
    res.update(bound_of(*total, F32_OPS_S), **route_bound(*total))
    log(f"[{phase}] {forward} {res['forward_launches']} K3 launches: {res['ms']:.4f} ms "
        f"({rate_and_shares(*total, res['ms'])}), plain {res['plain_ms']:.4f}, torch.matmul + K1 "
        f"{res['library_ms']:.4f}")
    return res


def stream_request(dev, name: str, state: dict, model_cfg: dict, engine: str, smi: str) -> None:
    """Phase 38: a STREAM_SECONDS mixture through ``infer.stream_file`` in pushes of STREAM_PUSH samples; the
    drained stream against ola_infer(chunk_batch=1) on the card; each window's forward timed by CUDA events."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "model_fqss8bit.pt")
        torch.save(state, ckpt)
        conf = {"model_cfg": {**model_cfg, "model_path": ckpt},
                "testing_cfg": {"segment_samples": STREAM_SEGMENT, "overlap": 0.25}}
        apply_fn = infer.load_engine(conf["model_cfg"], engine, dev)
        mix, _ = synth_batch(np.random.default_rng(38), 1, 2, STREAM_SECONDS * SR)
        path = os.path.join(tmp, "mixture.wav")
        save_audio(path, mix[0], SR)
        windows = []

        def timed(x):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            y = apply_fn(x)
            end.record()
            windows.append((start, end))
            return y

        t0 = time.perf_counter()
        _, out = infer.stream_file(timed, conf, path, STREAM_PUSH, os.path.join(tmp, "out"), device=dev)
        stream_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        latency = np.array([s.elapsed_time(e) for s, e in windows])
        wav, _ = read_audio(path)
        ref = ola_infer(apply_fn, wav, n_srcs=2, segment=STREAM_SEGMENT, overlap=0.25, chunk_batch=1, device=dev)
    err = float(np.abs(out - ref).max())
    if out.shape != ref.shape or not np.isfinite(out).all() or err > STREAM_TOL or len(latency) < 10:
        raise AssertionError(f"{name} stream ({engine}): shape {out.shape} vs {ref.shape}, max |diff| {err} "
                             f"(at most {STREAM_TOL}), {len(latency)} windows")
    log(f"[38] {name} stream ({engine}): {STREAM_SECONDS} s in {wav.shape[-1] // STREAM_PUSH} pushes of "
        f"{STREAM_PUSH} samples -> 2 sources of {out.shape[-1]} samples in {stream_s * 1000:.1f} ms, max |diff| "
        f"{err:.2e} from ola_infer(chunk_batch=1) (<= {STREAM_TOL}); per-window forward over {len(latency)} windows "
        f"of {STREAM_SEGMENT}: p50 {np.percentile(latency, 50):.2f} ms, p90 {np.percentile(latency, 90):.2f}, max "
        f"{latency.max():.2f} on {smi}")


def auto_requests(dev, name: str, state: dict, model_cfg: dict) -> None:
    """Phase 39: ``--engine auto`` through the infer entry: the table's path, bitwise equal to the folded engine at
    2 x 4 s and launching the weight-grid kernel only where that path is fake_quant, then three 20 s requests."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "model_fqss8bit.pt")
        torch.save(state, ckpt)
        cfg = {**model_cfg, "model_path": ckpt}
        auto, folded = infer.load_engine(cfg, "auto", dev), infer.load_engine(cfg, "folded", dev)
    x = torch.from_numpy(synth_batch(np.random.default_rng(39), 2, 2, 4 * SR)[0]).to(dev)
    reset_all_launches()
    with torch.inference_mode():
        y = auto(x)
        torch.cuda.synchronize()
        launched = all_launches()
        if (launched["weight"] > 0) != (BEST_PATHS[name] == "fake_quant") or not torch.equal(y, folded(x)):
            raise AssertionError(f"{name} auto ({BEST_PATHS[name]}): launches {launched}, equal to folded: "
                                 f"{torch.equal(y, folded(x))}")
    del auto, folded, y
    for i, sec in enumerate(serve_requests(dev, state, model_cfg, "auto")):
        log(f"[39] {name} request {i} (auto: the table's {BEST_PATHS[name]} path): 20 s mixture -> 2 sources of "
            f"20 s, {sec * 1000:.1f} ms; at 2 x 4 s bitwise equal to folded, {launched['weight']} weight-grid "
            f"launches")


def k3_slice(dev, smi: str, k3_shapes: list[tuple], states: dict) -> dict:
    """Phases 37-39: K3 against its plain version, streaming and --engine auto; returns K3's results."""
    qmm = check_qmatmul_kernel(dev, k3_shapes)  # 37.
    torch.cuda.empty_cache()
    configs = {"ConvTasNet": MODEL_CFG, "DPTNet": DPTNET_CFG, "Sepformer": SEPFORMER_CFG}
    for name, cfg in configs.items():
        for engine in ("folded", "auto"):
            stream_request(dev, name, states[name], cfg, engine, smi)  # 38.
        torch.cuda.empty_cache()
    for name, cfg in configs.items():
        auto_requests(dev, name, states[name], cfg)  # 39.
        torch.cuda.empty_cache()
    return qmm


def bf16_cfg(cfg: dict) -> dict:
    """A model_cfg with bf16 compute: ``quantization.compute_dtype: bfloat16``, as a user's YAML sets it."""
    return {**cfg, "quantization": {**cfg["quantization"], "compute_dtype": "bfloat16"}}


class _Unwrap:
    """A handle whose ``remove()`` takes an instance's wrapper of ``attr`` off again (as a hook's handle does)."""

    def __init__(self, obj, attr: str):
        self.obj, self.attr = obj, attr

    def remove(self) -> None:
        delattr(self.obj, self.attr)


def record_projections(model, record) -> list:
    """Wrap each attention's ``_project`` (its in- and out-projections: K5's core on the card) on the instance so
    that it first calls ``record(x, w)``; returns handles that take the wrappers off."""
    handles = []
    for m in model.modules():
        if isinstance(m, QMultiheadAttention):
            def project(x, w, b, plain=m._project):
                record(x, w)
                return plain(x, w, b)

            m._project = project
            handles.append(_Unwrap(m, "_project"))
    return handles


def record_dense_inputs(model, name: str) -> tuple[list, list]:
    """Hooks on ``model``'s K5 launches that record (name, M, K, N, grids) of every input they take: its QDense
    layers' (``grids`` True) and its attentions' projections (False, both grids off); returns the list and the
    hooks' handles."""
    seen = []
    handles = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((name, args[0].numel() // args[0].shape[-1], *mod.weight.shape[::-1], True)))
        for m in model.modules() if isinstance(m, QDense)]
    handles += record_projections(model, lambda x, w: seen.append(
        (f"{name} projection", x.numel() // x.shape[-1], *w.shape[::-1], False)))
    return seen, handles


def per_forward(records: list[tuple]) -> list[tuple]:
    """The distinct records of one forward, each with its count."""
    counts = {}
    for r in records:
        counts[r] = counts.get(r, 0) + 1
    return [(*r, n) for r, n in counts.items()]


def infer_cli_request(name: str, state: dict | None, model_cfg: dict, engine: str, seconds: int = 20,
                      model_path: str | None = None) -> float:
    """One ``seconds`` mixture through ``python -m fqss_tpu_torch.infer`` (its own process, on the card), the
    config written as JSON with the weights and ranges of ``state`` (or ``model_path``, a checkpoint on disk);
    returns the process's seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = model_path or os.path.join(tmp, "model_fqss8bit.pt")
        if model_path is None:
            torch.save(state, ckpt)
        conf = {"model_cfg": {**model_cfg, "model_path": ckpt},
                "testing_cfg": {"segment_samples": 16000, "overlap": 0.25}}
        cfg_path, wav_path, out_dir = (os.path.join(tmp, f) for f in ("conf.json", "mixture.wav", "out"))
        with open(cfg_path, "w") as fh:
            json.dump(conf, fh)
        mix, _ = synth_batch(np.random.default_rng(40), 1, 2, seconds * SR)
        save_audio(wav_path, mix[0], SR)
        env_vars = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "fqss_tpu_torch.infer", "-y", cfg_path, "-a", wav_path, "-o",
                               out_dir, "--engine", engine], cwd=tmp, env=env_vars, capture_output=True, text=True,
                              timeout=600)
        sec = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"{name}: python -m fqss_tpu_torch.infer failed ({proc.returncode}):\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        for s in range(2):
            wav, fs = read_audio(os.path.join(out_dir, f"source_{s + 1}.wav"))
            if wav.shape[-1] != seconds * SR or fs != SR or not np.isfinite(wav).all():
                raise AssertionError(f"{name} infer source {s + 1}: {wav.shape[-1]} samples at {fs} Hz")
    return sec


def in_turns(models: dict, x: torch.Tensor) -> dict:
    """ms per forward of each model (CUDA events, 3 forwards after a warm-up), in turns: the models in order, then
    in reverse order; the mean of the two readings each."""
    times = {name: [] for name in models}
    for name in [*models, *reversed(list(models))]:
        with torch.inference_mode():
            times[name].append(cuda_ms(lambda: models[name](x), 3))
    return {name: sum(t) / len(t) for name, t in times.items()}


def serve_bf16_model(dev, smi: str, phase: int, name: str, f32: torch.nn.Module, model: torch.nn.Module,
                     cpu_model: torch.nn.Module, mix: np.ndarray, want: dict, records: list) -> dict:
    """Phases 40-42 for one model: the bf16 forward at ``mix`` with its launches (``want``: the module tree's),
    folded bitwise equal with no weight launch, card vs CPU at 1 x 1 s, the distance from the float32 forward, and
    the forwards' times in turns with float32's; returns the launches."""
    x = torch.from_numpy(mix).to(dev)
    k3_seen, k3_hooks = record_k3_inputs(model, name)
    k5_seen, k5_hooks = record_dense_inputs(model, name)
    reset_all_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        y = model(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = all_launches()
    for h in (*k3_hooks, *k5_hooks):
        h.remove()
    records.append((k5_seen, k3_seen))
    if tuple(y.shape) != (x.shape[0], 2, x.shape[-1]) or not torch.isfinite(y).all():
        raise AssertionError(f"{name} bf16 forward gave shape {tuple(y.shape)}, finite={bool(torch.isfinite(y).all())}")
    if launches != want:
        raise AssertionError(f"{name} bf16 launches {launches} != {want}")
    with torch.inference_mode():
        y32 = f32(x)
    snr32 = snr_db(y32, y)
    log(f"[{phase}] {name} bf16 forward {tuple(x.shape)} -> {tuple(y.shape)}, finite, first call {first_s:.2f} s; "
        f"launches {({k: v for k, v in launches.items() if v})} (= the module tree: the bf16 routes "
        f"dense_bf16 / qmatmul_bf16 / attention_bf16 for every QDense, K3 conv and attention core, no float32 route); "
        f"from the float32 forward on the same weights: SNR min {snr32.min().item():.2f} dB, mean "
        f"{snr32.mean().item():.2f} dB")
    del y32

    folded = fold_quantized_weights(model)
    reset_all_launches()
    with torch.inference_mode():
        y_folded = folded(x)
    torch.cuda.synchronize()
    folded_launches = all_launches()
    if folded_launches != {**want, "weight": 0}:
        raise AssertionError(f"the folded bf16 {name} launched {folded_launches}, want {({**want, 'weight': 0})}")
    if not torch.equal(y_folded, y):
        raise AssertionError(f"folded bf16 {name} != fake-quant, max abs diff {(y_folded - y).abs().max().item()}")
    del y_folded, y

    x1 = torch.from_numpy(mix[:1, :SR])
    with torch.inference_mode():
        y_card = model(x1.to(dev)).cpu()
        y_cpu = cpu_model(x1)
    snr = snr_db(y_cpu, y_card)
    if not bool((snr >= BF16_CARD_VS_CPU_DB).all()):
        raise AssertionError(f"{name} bf16 card vs CPU SNR {snr.tolist()} dB < {BF16_CARD_VS_CPU_DB} dB")
    log(f"[{phase}] {name} bf16: folded bitwise equal to fake_quant, weight launches 0, the same bf16 route launches; "
        f"card vs CPU (the CPU's plain versions in bf16) at 1 x {SR}: SNR "
        f"{[round(v, 2) for v in snr.flatten().tolist()]} dB (>= {BF16_CARD_VS_CPU_DB}), "
        f"{(y_card != y_cpu).float().mean().item():.4f} of samples differ")

    ms = in_turns({"float32 fake_quant": f32, "bf16 fake_quant": model, "bf16 folded": folded}, x)
    audio_s = x.shape[0] * x.shape[-1] / SR
    log(f"[{phase}] {name} throughput at {x.shape[0]} x {x.shape[-1] // SR} s, in turns: " + ", ".join(
        f"{k} {audio_s / (v / 1000):.1f} sec-audio/s ({v:.2f} ms a forward)" for k, v in ms.items()) + f" on {smi}")
    del folded
    torch.cuda.empty_cache()
    return launches


def serve_bf16(dev, smi: str, states: dict) -> tuple[list, list, list]:
    """Phases 40-42: the flagship (ConvTasNet FQSS-8bit, bench.py's bf16 configuration) at 32 x 12 s with one
    request through python -m fqss_tpu_torch.infer, then DPTNet and the Sepformer at 8 x 4 s, each in bf16 compute
    with the weights and ranges of its float32 phases. Returns the K5 and K3 shapes the forwards gave their bf16
    routes (name, shape..., launches a forward), the K8 shapes, and each forward's launches."""
    records, attn_shapes, launches = [], [], []
    # 40. the flagship
    mix, _ = synth_batch(np.random.default_rng(0), BATCH, 2, SEG)
    models = []
    for spec, device in ((SPEC, dev), (BF16_SPEC, dev), (BF16_SPEC, torch.device("cpu"))):
        m = ConvTasNet(n_srcs=2, kernel_size=16, stride=8, q=spec)
        m.load_state_dict(states["ConvTasNet"])
        models.append(m.to(device).eval())
    fused = fused_convs(models[1])
    n_act = sum(isinstance(m, ActQuantizer) for m in models[1].modules())
    want = no_launches(act=n_act - fused["act"], weight=1, qmatmul_bf16=fused["qmatmul"])
    launches.append(serve_bf16_model(dev, smi, 40, "ConvTasNet", *models, mix, want, records))
    del models
    torch.cuda.empty_cache()
    sec = infer_cli_request("ConvTasNet", states["ConvTasNet"], bf16_cfg(MODEL_CFG), "folded")
    log(f"[40] python -m fqss_tpu_torch.infer --engine folded with compute_dtype bfloat16: 20 s mixture -> 2 sources "
        f"of 20 s in {sec:.1f} s (the process, the model's build and the kernels' load included)")

    # 41-42. DPTNet and the Sepformer
    for phase, name, cfg, batch, seg, shapes_of in ((41, "DPTNet", DPTNET_CFG, DPT_BATCH, DPT_SEG,
                                                     dptnet_attention_shapes),
                                                    (42, "Sepformer", SEPFORMER_CFG, SEP_BATCH, SEP_SEG,
                                                     sepformer_attention_shapes)):
        mix, _ = synth_batch(np.random.default_rng(phase), batch, 2, seg)
        models = []
        for c, device in ((cfg, dev), (bf16_cfg(cfg), dev), (bf16_cfg(cfg), torch.device("cpu"))):
            m = create_pretrained_model(c, observer=False, device=device)
            m.load_state_dict(states[name])
            models.append(m.eval())
        model = models[1]
        counts = count_quantizers(model.modules())
        n_mha = sum(isinstance(m, QMultiheadAttention) for m in model.modules())
        dense, fused = dense_quantizers(model), fused_convs(model)
        # every act quantizer but the attention's two no-op sites and its head grid (in K8's epilogue), the QDense
        # layers' (in K5) and the K3 convs' (in K3)
        want = no_launches(act=counts["act"] - 3 * n_mha - dense["act"] - fused["act"], weight=1,
                           bilstm=2 * model.layer if name == "DPTNet" else 0, attention_bf16=n_mha,
                           dense_bf16=dense["dense"], qmatmul_bf16=fused["qmatmul"])
        launches.append(serve_bf16_model(dev, smi, phase, name, *models, mix, want, records))
        attn_shapes += shapes_of(model)
        del models, model
        torch.cuda.empty_cache()
    k5 = per_forward([r for k5_seen, _ in records for r in k5_seen])
    k3 = per_forward([r for _, k3_seen in records for r in k3_seen])
    return k5, k3, attn_shapes, launches


def bf16_library(batched: bool) -> str | None:
    """None where torch offers a product of bf16 operands with a float32 output (``torch.mm``, or ``torch.bmm``
    where ``batched``, with ``out_dtype=torch.float32``) on this card, else why it does not: the bf16 routes'
    library call."""
    a = torch.ones(1, 16, 16, device="cuda", dtype=torch.bfloat16)
    try:
        out = torch.bmm(a, a, out_dtype=torch.float32) if batched else torch.mm(a[0], a[0], out_dtype=torch.float32)
    except (TypeError, RuntimeError) as e:
        return f"torch {torch.__version__} has no {'bmm' if batched else 'mm'} of bf16 operands to float32: {e}"
    return None if out.dtype == torch.float32 else f"out_dtype gave {out.dtype}"


def check_bf16_dense(dev, k5_shapes: list[tuple], k3_shapes: list[tuple]) -> tuple[dict, dict]:
    """Phase 43 (K5, K3): the bf16 routes against their plain versions at the shapes phases 41-42's bf16 forwards
    gave them and at odd ones, every grid and observing-flag combination (phases 31 and 37's rules); times of the bf16
    route, the float32 route at the same shapes, the bf16 plain version and the library call (bf16 operands, float32
    output, then K1), summed over phases 40-42's forwards (DPTNet's and the Sepformer's), with the bf16 bound."""
    gen = torch.Generator(device=dev).manual_seed(43)
    out = {}
    for kernel, shapes, odd in (("K5", k5_shapes, DENSE_ODD), ("K3", k3_shapes, QMM_ODD)):
        why_not = bf16_library(batched=kernel == "K3")
        res = {"max_abs_err": 0.0, "ms": 0.0, "f32_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "launches": 0}
        total = [0, 0]
        for name, *shape, count in [*shapes, *(("odd", *s, *((True,) if kernel == "K5" else ()), 0) for s in odd)]:
            grids = True
            if kernel == "K5":  # (M, K, N, grids): the projections run with both grids off
                *shape, grids = shape
            case = dense_case(dev, *shape, gen) if kernel == "K5" else qmatmul_case(dev, *shape, gen)
            for flags in DENSE_FLAGS:
                err = (check_dense_forward(f"bf16 {name} {flags}", dense_args(case, flags), bf16=True)
                       if kernel == "K5" else check_qmatmul(f"bf16 {name} {shape}", case, flags, bf16=True))
                res["max_abs_err"] = max(res["max_abs_err"], err)
            line = (f"[43] {kernel} bf16 route {name} {shape}: every grid and observing-flag combination "
                    f"({len(DENSE_FLAGS)}) within its bounds (DENSE_RTOL of sum |term| of the rounded operands), "
                    f"planted ties and clip extremes exact{'' if grids else '; timed with both grids off'}")
            if count == 0:
                log(line)
                continue
            if kernel == "K5":
                x, w, b, w_mn, w_mx, a_mn, a_mx = case
                if not grids:
                    w_mn = w_mx = a_mn = a_mx = None
                wq = fq.weight_fake_quant(w, w_mn, w_mx, 8, 0) if grids else w
                run = lambda bf16: qd.qat_dense(x, w, b, w_mn, w_mx, a_mn, a_mx, bf16=bf16)
                plain = lambda: qd.qat_dense_ref(x, w, b, w_mn, w_mx, a_mn, a_mx, bf16=True)
                product = lambda: torch.mm(x.bfloat16(), wq.bfloat16().t(), out_dtype=torch.float32).add_(b)
                library = (lambda: fq.act_fake_quant(product(), a_mn, a_mx, 8)) if grids else product
                nbytes, ops = dense_bounds(*shape)[0]
            else:
                x, w, w_mn, w_mx, a_mn, a_mx = case
                wq = fq.weight_fake_quant(w, w_mn, w_mx, 8, 0)
                run = lambda bf16: qm.qmatmul(x, w, w_mn, w_mx, a_mn, a_mx, bf16=bf16)
                plain = lambda: qm.qmatmul_ref(x, w, w_mn, w_mx, a_mn, a_mx, bf16=True)
                library = lambda: fq.act_fake_quant(torch.bmm(wq.bfloat16().expand(x.shape[0], *wq.shape),
                                                              x.bfloat16(), out_dtype=torch.float32), a_mn, a_mx, 8)
                nbytes, ops = qmatmul_bound(*shape)
            times = {"ms": cuda_ms(lambda: run(True), 10), "f32_ms": cuda_ms(lambda: run(False), 10),
                     "plain_ms": cuda_ms(plain, 10), "library_ms": cuda_ms(library, 10) if why_not is None else None}
            b16 = bound_of(nbytes, ops, BF16_OPS_S)
            log(f"{line}; bf16 route {times['ms']:.4f} ms ({ops / times['ms'] / 1e9:.1f} TFLOP/s, "
                f"{b16['bound_ms'] / times['ms']:.1%} of its {b16['bound_ms']:.4f} ms bf16 bound by "
                f"{b16['bound_by']}), "
                f"float32 route {times['f32_ms']:.4f} ms, bf16 plain {times['plain_ms']:.4f} ms, library "
                + (f"{times['library_ms']:.4f} ms" if why_not is None else f"none ({why_not})")
                + f"; {count} a forward")
            for key, val in times.items():
                res[key] = None if val is None else res[key] + count * val
            res["launches"] += count
            total = [total[0] + count * nbytes, total[1] + count * ops]
            del case, x, w, wq
            torch.cuda.empty_cache()
        b16 = bound_of(*total, BF16_OPS_S)
        res.update(bound_ms=b16["bound_ms"], bound_by=b16["bound_by"], library_note=why_not)
        log(f"[43] phases 40-42's bf16 forwards' {res['launches']} {kernel} launches: bf16 route "
            f"{res['ms']:.4f} ms against a {b16['bound_ms']:.4f} ms bf16 bound by {b16['bound_by']} "
            f"({b16['bound_ms'] / res['ms']:.1%}), float32 route {res['f32_ms']:.4f} ms, bf16 plain "
            f"{res['plain_ms']:.4f} ms, library " + (f"{res['library_ms']:.4f} ms" if why_not is None else "none"))
        out[kernel] = res
    return out["K5"], out["K3"]


def check_bf16_attention(dev, shapes: list[tuple], phase: int = 43, models: tuple = ("Sepformer", "DPTNet"),
                         odd: bool = True) -> dict:
    """Phase 43 (and 59) (K8): the bf16 route through both entries against its plain version at the bf16 forwards'
    attention shapes (and ATTN_ODD with ``odd``), the first query of every head planted (ATTN_BF16_TIE_ULPS's rule;
    the quantized heads by phase 24's); times of the packed entry on the bf16 route and on the float32 route, the
    bf16 plain version (median of ATTN_PLAIN_REPS), per forward of each of ``models`` (the first one's keys
    unprefixed), with the bf16 bound."""
    gen = torch.Generator(device=dev).manual_seed(100 + phase)
    keys = ("ms", "f32_ms", "plain_ms", "moved", "ops")
    sums = {model: dict.fromkeys(keys, 0.0) for model in models}
    launches = {model: 0 for model in sums}
    results = {"max_abs_err": 0.0}
    tie_rows = [0, 0]
    for name, bh, lq, lk, d, count, model, h in [*shapes, *([("odd", *ATTN_ODD, 0, None, 1)] if odd else [])]:
        qs = torch.randn(bh, lq, d, device=dev, generator=gen) * 0.3
        qs[:, 0] *= ATTN_PLANT
        k, v = (torch.randn(bh, lk, d, device=dev, generator=gen) for _ in range(2))
        views = packed_views(qs, k, v, h)
        with torch.no_grad():
            ref = k8.fused_attention_ref(qs, k, v, quantize=False, bf16=True)
            mn, mx = ref.min().reshape(1), ref.max().reshape(1)
            heads = k8.fused_attention(qs, k, v, quantize=False, bf16=True)
            got = k8.fused_attention(qs, k, v, mn, mx, 8, bf16=True)
            packed = heads_of(k8.fused_attention_packed(*views, quantize=False, bf16=True), h)
            packed_got = heads_of(k8.fused_attention_packed(*views, mn, mx, 8, bf16=True), h)
            plain = k8.fused_attention_ref(qs, k, v, mn, mx, 8, bf16=True)
            # the plain version's softmax weights: those near a bf16 tie, and one bf16 step of p |v| over them
            p = k8.softmax_ref(torch.matmul(bf16_round(qs), bf16_round(k).transpose(-1, -2)))
            near = k8.bf16_tie_mask(p, ATTN_BF16_TIE_ULPS)
            slack = 2.0**-7 * torch.matmul(bf16_round(p) * near, bf16_round(v).abs())
            rows = near.any(-1)
            del p, near
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        diff_f = (heads - ref).abs()
        err = diff_f.max().item()
        clean = diff_f[~rows].max().item() if bool((~rows).any()) else 0.0
        beyond = (diff_f > ATTN_REL_TOL * scale + slack).any(-1)
        n_rows, n_tie = rows.numel(), int(rows.sum().item())
        tie_rows = [tie_rows[0] + n_tie, tie_rows[1] + n_rows]
        step = (mx - mn).item() / 255
        diff = (got - plain).abs()
        share = (diff > 0.5 * step).float().mean().item()
        if not torch.equal(packed, heads) or not torch.equal(packed_got, got):
            raise AssertionError(f"K8 bf16 {name}: the packed entry's heads differ from the [BH, L, d] entry's")
        if bool(beyond.any()):
            raise AssertionError(f"K8 bf16 {name} [{bh},{lq},{lk},{d}]: {int(beyond.sum())} rows beyond ATTN_REL_TOL x "
                                 f"{scale:.3g} (plus one bf16 step of p |v| over the weights within "
                                 f"{ATTN_BF16_TIE_ULPS} ulps of a bf16 tie), {int((beyond & ~rows).sum())} of them "
                                 f"without such a weight; max |kernel - plain| {err:.3g}")
        if not torch.equal(got, fq.act_fake_quant_ref(heads, mn, mx, 8)):
            raise AssertionError(f"K8 bf16 {name}: the epilogue is not the plain grid of the kernel's own float heads")
        if diff.max().item() > step * (1 + 1e-4) or share > ATTN_GRID_SHARE:
            raise AssertionError(f"K8 bf16 {name}: quantized heads {diff.max().item() / step:.3f} steps from the plain "
                                 f"version's, {share:.2e} of them a step apart (at most {ATTN_GRID_SHARE})")
        results["max_abs_err"] = max(results["max_abs_err"], err)
        line = (f"[{phase}] K8 bf16 route {name} BH {bh} x Lq {lq} x Lk {lk} x d {d} ({k8.plan(bh, lq, lk, d, True)}): "
                f"float heads max |kernel - plain| {err:.3g} ({err / scale:.2e} of max |heads| {scale:.3g}); rows "
                f"with no softmax weight within {ATTN_BF16_TIE_ULPS} ulps of a bf16 tie {clean / scale:.2e} (<= "
                f"{ATTN_REL_TOL}); {n_tie} rows of {n_rows} ({n_tie / n_rows:.2e}) with such a weight, each within "
                f"one bf16 step of p |v| over them; on the grid max {diff.max().item() / step:.0f} step, {share:.2e} "
                f"of values a step apart (<= {ATTN_GRID_SHARE}), each its own float head on the plain grid; the "
                f"packed entry bitwise equal")
        if name == "odd":
            log(line)
            continue
        ms = cuda_ms(lambda: k8.fused_attention_packed(*views, mn, mx, 8, bf16=True), 10)
        f32_ms = cuda_ms(lambda: k8.fused_attention_packed(*views, mn, mx, 8), 10)
        plain_ms, lo, hi = median_ms(lambda: k8.fused_attention_ref(qs, k, v, mn, mx, 8, bf16=True), ATTN_PLAIN_REPS)
        moved, ops = attention_bound(bh, lq, lk, d)
        b = bound_of(moved, ops, BF16_OPS_S)
        log(f"{line}; bf16 route {ms:.4f} ms ({b['bound_ms'] / ms:.1%} of its {b['bound_ms']:.4f} ms bf16 bound by "
            f"{b['bound_by']}), float32 route {f32_ms:.4f} ms, bf16 plain {plain_ms:.4f} ms (median of "
            f"{ATTN_PLAIN_REPS}, {lo:.4f}-{hi:.4f}); {count} launches a {model} forward")
        for key, val in zip(keys, (ms, f32_ms, plain_ms, moved, ops)):
            sums[model][key] += count * val
        launches[model] += count
        del qs, k, v, views, ref, heads, got, packed, packed_got, plain, slack, diff, diff_f
        torch.cuda.empty_cache()
    for model, t in sums.items():
        b = bound_of(t["moved"], t["ops"], BF16_OPS_S)
        log(f"[{phase}] one {model} bf16 forward's {launches[model]} K8 launches: bf16 route {t['ms']:.3f} ms against "
            f"a "
            f"{b['bound_ms']:.3f} ms bf16 bound by {b['bound_by']} ({b['bound_ms'] / t['ms']:.1%}), float32 route "
            f"{t['f32_ms']:.3f} ms, bf16 plain {t['plain_ms']:.2f} ms")
        prefix = "" if model == models[0] else f"{model.lower()}_"
        results.update({f"{prefix}ms": t["ms"], f"{prefix}f32_ms": t["f32_ms"], f"{prefix}plain_ms": t["plain_ms"],
                        f"{prefix}bound_ms": b["bound_ms"], f"{prefix}launches": launches[model]})
    results["tie_rows"], results["rows"] = tie_rows
    log(f"[{phase}] K8 bf16: {tie_rows[0]} rows of {tie_rows[1]} ({tie_rows[0] / tie_rows[1]:.2e}) held by the tie "
        f"rule")
    return results


def music_mix(seed: int, batch: int, length: int) -> np.ndarray:
    """Stereo mixtures [B, 2, T]: the sums of seeded synthetic stems (``synth_music_batch``) at MUSIC_SR."""
    return synth_music_batch(np.random.default_rng(seed), batch, length, sample_rate=MUSIC_SR).sum(axis=1)


def build_served_music(dev, **arch) -> ConvTasNetMusic:
    """The full-width ConvTasNet-music of MUSIC_CFG (``arch``: keys of the model_cfg that change its depth) from a
    seeded generator, its ranges from the config's observer window over MUSIC_OBSERVE's stems, returned in eval()
    mode with the observer off."""
    batch, length, steps = MUSIC_OBSERVE
    cfg = {**MUSIC_CFG, **arch}
    model = create_model(cfg, generator=torch.Generator().manual_seed(44)).to(dev).train()
    if model.q.max_observations != steps:
        raise AssertionError(f"the config's observer window is {model.q.max_observations} steps, not {steps}")
    x = torch.from_numpy(music_mix(44, batch, length)).to(dev)
    with torch.no_grad():
        for _ in range(steps):
            model(x)
    served = create_model(cfg, dataclasses.replace(model.q, observer=False))
    served.load_state_dict(model.state_dict())
    return served.to(dev).eval()


def music_on_cpu(served: ConvTasNetMusic) -> ConvTasNetMusic:
    """The served model on the CPU: the same weights and ranges, in eval() mode."""
    cpu_model = create_model({**MUSIC_CFG, "n_blocks": served.n_blocks, "n_repeats": served.n_repeats}, served.q)
    cpu_model.load_state_dict(state_on_cpu(served))
    return cpu_model.eval()


def music_serving_launches(model: ConvTasNetMusic) -> dict:
    """A serving forward's launches: K1 per act quantizer module but the K3 convs' (K3 applies their grids), one
    grouped weight launch, K3 per bias-free 1x1 conv (the bottleneck and every block's pointwise)."""
    fused = fused_convs(model)
    return no_launches(act=count_quantizers(model.modules())["act"] - fused["act"], weight=1,
                       qmatmul=fused["qmatmul"])


def music_int8_cases(model: ConvTasNetMusic) -> list[tuple]:
    """(M, K, N, nl, alpha, grids, what, launches a forward) of the music int8 engine's K4 launches at MUSIC_BATCH x
    MUSIC_SEG: the bottleneck, each block's conv1x1 (PReLU) and pointwise, the mask conv (ReLU), the decoder (one row
    a stem, frame and batch element)."""
    frames = (MUSIC_SEG - model.kernel_size) // model.stride + 1
    m, n_f = MUSIC_BATCH * frames, model.n_filters
    bn, hid = model.separator.bottleneck.weight.shape[0], model.separator.blocks[0].conv1x1.weight.shape[0]
    blocks, one = len(model.separator.blocks), (INT8_TIE_DELTA, INT8_TIE_MN)
    return [(m, n_f, bn, "prelu", 1.0, one, "bottleneck", 1),
            (m, bn, hid, "prelu", 0.25, one, "conv1x1", blocks),
            (m, hid, bn, "prelu", 1.0, one, "pointwise", blocks),
            (m, bn, model.n_srcs * n_f, "prelu", 0.0, one, "mask_conv", 1),
            (m * model.n_srcs, n_f, model.audio_channels * model.kernel_size, "prelu", 1.0, one, "decoder", 1)]


def music_forwards(dev, smi: str) -> tuple:
    """Phases 44-48, the ConvTasNet-music serving path at full width. Returns (the phase-44 launches, the K3 shapes
    of its forward with their launches, the int8 engine's K4 launches, the throughputs, the model's state)."""
    served = build_served_music(dev)
    x = torch.from_numpy(music_mix(45, MUSIC_BATCH, MUSIC_SEG)).to(dev)
    n_params = sum(p.numel() for n, p in served.named_parameters() if "fake_quantize" not in n)
    want = music_serving_launches(served)
    k3_shapes, handles = record_k3_inputs(served, "music")
    reset_all_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        y = served(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = all_launches()
    for h in handles:
        h.remove()
    shape = (MUSIC_BATCH, served.n_srcs, served.audio_channels, MUSIC_SEG)
    if tuple(y.shape) != shape or not torch.isfinite(y).all():
        raise AssertionError(f"music forward gave shape {tuple(y.shape)}, finite={bool(torch.isfinite(y).all())}")
    if launches != want:
        raise AssertionError(f"music forward launches {launches} != {want}")
    log(f"[44] ConvTasNet-music at full width ({n_params} parameters; ranges from the config's "
        f"{MUSIC_OBSERVE[2]}-step observer window over {MUSIC_OBSERVE[0]} x {MUSIC_OBSERVE[1]} stereo samples): "
        f"{tuple(x.shape)} -> {tuple(y.shape)}, finite, first call {first_s:.2f} s; launches "
        f"{', '.join(f'{k}={v}' for k, v in launches.items() if v)} (K1 = act quantizers but the {want['qmatmul']} "
        f"K3 convs', one grouped weight launch, K3 = the bottleneck and the 40 pointwise convs), all others 0")

    # 45. at full depth the card's own floor on one chunk (phase 47 holds the int8 engines to it); card vs CPU at one
    # repeat, >= 20 dB (MUSIC_CPU_DEPTH)
    x1 = x[:1]
    with torch.inference_mode():
        y_card, y_own = served(x1).cpu(), served(x1 * (1 + MUSIC_PERTURB)).cpu()
    own, lsb = snr_db(y_card, y_own), out_step(served)
    floor = (own.min().item(), (y_own - y_card).abs().mean().item() / lsb)
    log(f"[45] music at full depth, the card against itself on one chunk {tuple(x1.shape)} times (1 + 2^-22): "
        f"{own.min().item():.2f}-{own.max().item():.2f} dB, mean {floor[1]:.4f} output steps (the floor of phase 47)")
    shallow = build_served_music(dev, **MUSIC_SHALLOW)
    cpu_model = music_on_cpu(shallow)
    t0 = time.perf_counter()
    with torch.inference_mode():
        y_card, y_cpu = shallow(x1).cpu(), cpu_model(x1.cpu())
    cpu_s = time.perf_counter() - t0
    snr = snr_db(y_cpu, y_card)
    if not bool((snr >= 20).all()):
        raise AssertionError(f"music card vs CPU at {MUSIC_SHALLOW}: SNR {snr.tolist()} dB < 20 dB")
    log(f"[45] the same width at {MUSIC_SHALLOW} ({len(shallow.separator.blocks)} blocks): card vs CPU SNR "
        f"{[round(v, 2) for v in snr.flatten().tolist()]} dB (>= 20); {cpu_s:.1f} s")
    del y_own

    # 46. folded
    folded = fold_quantized_weights(served)
    reset_all_launches()
    with torch.inference_mode():
        y_folded = folded(x)
    torch.cuda.synchronize()
    if all_launches()["weight"] or not torch.equal(y_folded, y):
        raise AssertionError(f"music folded: launches {all_launches()}, max |diff| {(y_folded - y).abs().max()}")
    log(f"[46] music folded engine: bitwise equal to fake-quant, {all_launches()['qmatmul']} K3 launches with their "
        f"weight grids off, no weight-kernel launch")
    del y_folded

    # 47. the int8 engines: K4 launches = the module tree's 1x1 convs + the decoder, floor rule, card vs CPU
    sites = 2 + 2 * len(served.separator.blocks) + 1  # bottleneck, mask conv, conv1x1 and pointwise, decoder
    engines = {}
    for dtype, (snr_margin, mean_factor) in INT8_FLOOR.items():
        engine = engines[dtype] = make_int8_engine(served, compute_dtype=dtype)
        reset_all_launches()
        y8 = engine(x)
        torch.cuda.synchronize()
        got = all_launches()
        if got != no_launches(int8_mm=sites):
            raise AssertionError(f"music int8 engine ({dtype}) launches {got}, expected {sites} int8_mm only")
        if y8.shape != y.shape or not torch.isfinite(y8).all():
            raise AssertionError(f"music int8 engine ({dtype}) gave shape {tuple(y8.shape)}")
        diff = (y8 - y).abs()
        snr8, mean_lsb = snr_db(y, y8), diff.mean().item() / lsb
        snr_min, mean_max = floor[0] - snr_margin, floor[1] * mean_factor
        if snr8.min().item() < snr_min or mean_lsb > mean_max:
            raise AssertionError(f"music int8 engine ({dtype}) vs fake-quant: SNR {snr8.min().item():.2f} dB (minimum "
                                 f"{snr_min:.2f}), mean {mean_lsb:.3f} output steps (maximum {mean_max:.3f})")
        log(f"[47] music int8 engine ({dtype} float products) {tuple(x.shape)}: finite; launches int8_mm={sites} "
            f"(the bottleneck, 40 conv1x1, 40 pointwise, the mask conv, the decoder), all others 0; vs fake-quant "
            f"SNR {snr8.min().item():.2f}-{snr8.max().item():.2f} dB (>= {snr_min:.2f}, phase 45's floor), mean "
            f"{mean_lsb:.4f} output steps (<= {mean_max:.3f}), max {diff.max().item() / lsb:.2f}")
        del y8, diff
    xc = x[:1, :, :MUSIC_CPU_SEG]
    t0 = time.perf_counter()
    for dtype in INT8_CARD_VS_CPU:  # at one repeat, within the engine's own floor there
        engine = make_int8_engine(shallow, compute_dtype=dtype)
        y_card, y_cpu = engine(xc).cpu(), make_int8_engine(cpu_model, compute_dtype=dtype)(xc.cpu())
        y_own = engine(xc * (1 + MUSIC_PERTURB)).cpu()
        snr8, own = snr_db(y_cpu, y_card), snr_db(y_card, y_own)
        step_s = out_step(shallow)
        mean8 = (y_card - y_cpu).abs().mean().item() / step_s
        own_mean = (y_own - y_card).abs().mean().item() / step_s
        snr_min, mean_max = own.min().item() - MUSIC_FLOOR_RULE[0], own_mean * MUSIC_FLOOR_RULE[1]
        if snr8.min().item() < snr_min or mean8 > mean_max:
            raise AssertionError(f"music int8 engine ({dtype}) card vs CPU: SNR {snr8.tolist()} dB (minimum "
                                 f"{snr_min:.2f}), mean {mean8:.3f} output steps (maximum {mean_max:.3f})")
        log(f"[47] music int8 engine ({dtype}) card vs CPU at {tuple(xc.shape)}, {MUSIC_SHALLOW}: SNR "
            f"{snr8.min().item():.2f}-{snr8.max().item():.2f} dB, mean {mean8:.4f} output steps; the card against "
            f"itself on the input times (1 + 2^-22): {own.min().item():.2f}-{own.max().item():.2f} dB, mean "
            f"{own_mean:.4f}: within that floor (SNR >= {snr_min:.2f}, mean <= {mean_max:.3f})")
    log(f"[47] the two engines' card-vs-CPU runs in {time.perf_counter() - t0:.1f} s")
    del cpu_model, shallow, engine

    # 48. throughput of every engine, bf16 compute included
    bf16 = create_model(MUSIC_CFG, dataclasses.replace(served.q, compute_dtype="bfloat16"))
    bf16.load_state_dict(served.state_dict())
    bf16 = bf16.to(dev).eval()
    audio_s = MUSIC_BATCH * MUSIC_SEG / MUSIC_SR
    throughput = {}
    for name, engine in (("fake_quant", served), ("folded", folded), ("int8 float32", engines["float32"]),
                         ("int8 bfloat16", engines["bfloat16"]), ("fake_quant bf16", bf16)):
        with torch.inference_mode():
            ms = cuda_ms(lambda: engine(x), MUSIC_THROUGHPUT_REPS)
        throughput[name] = ms
        log(f"[48] music throughput {name}: {audio_s / (ms / 1000):.1f} sec-audio/s ({ms:.1f} ms per forward of "
            f"{MUSIC_BATCH} x {MUSIC_SEG / MUSIC_SR:g} s stereo) on {smi}")
    k3 = [(*entry, k3_shapes.count(entry)) for entry in dict.fromkeys(k3_shapes)]  # each shape with its launches
    return launches, k3, sites, throughput, state_on_cpu(served)


def music_kernels(dev, k3_shapes: list[tuple]) -> tuple[dict, dict]:
    """Phase 49: K3 and K4 against their plain versions at the shapes of the music forward and int8 engine."""
    qmm = check_qmatmul_kernel(dev, k3_shapes, 49, "one music serving forward's")
    torch.cuda.empty_cache()
    model = create_model(MUSIC_CFG, QuantSpec())
    k4 = check_int8_cases(dev, 49, "music", music_int8_cases(model), 49)
    torch.cuda.empty_cache()
    return qmm, k4


def music_evaluation(dev, state: dict) -> dict:
    """Phase 50: ``val.evaluate`` (MUSDB NSDR) of the fake_quant and int8 engines on a MUSDB-layout test split of two
    12 s tracks of synthetic stereo stems at MUSIC_SR."""
    stems = synth_music_batch(np.random.default_rng(50), 2, 12 * MUSIC_SR, sample_rate=MUSIC_SR)
    sources = MUSIC_CFG["sources"]
    with tempfile.TemporaryDirectory() as tmp:
        for i, track in enumerate(stems):
            d = os.path.join(tmp, "test", f"track_{i}")
            save_audio(os.path.join(d, "mixture.wav"), np.clip(track.sum(0), -0.99, 0.99), MUSIC_SR)
            for s, name in enumerate(sources):
                save_audio(os.path.join(d, f"{name}.wav"), track[s], MUSIC_SR)
        ckpt = os.path.join(tmp, "convtasnet_music_fqss8bit.pt")
        torch.save(state, ckpt)
        conf = {"model_cfg": {**MUSIC_CFG, "model_path": ckpt}, "dataset_cfg": {"name": "musdbhq"},
                "testing_cfg": {"test_dir": tmp, "NSDR": True, "segment_samples": MUSIC_SEG, "overlap": 0.25}}
        results = {}
        for engine in ("fake_quant", "int8"):
            t0 = time.perf_counter()
            results[engine] = val.evaluate(conf, engine, dev)
            log(f"[50] val.evaluate --engine {engine}, MUSDB NSDR over 2 tracks of 12 s: "
                + ", ".join(f"{k} {v:.4f}" for k, v in results[engine].items())
                + f" in {time.perf_counter() - t0:.1f} s")
    for engine, m in results.items():
        if not np.isfinite(list(m.values())).all():
            raise AssertionError(f"music evaluation of {engine}: non-finite metrics {m}")
    gap = abs(results["int8"]["nsdr"] - results["fake_quant"]["nsdr"])
    if gap > EVAL_NSDR_DB:
        raise AssertionError(f"int8 mean NSDR {gap:.3f} dB from fake_quant's (bound {EVAL_NSDR_DB})")
    log(f"[50] int8 vs fake_quant mean NSDR: {gap:.4f} dB apart (<= {EVAL_NSDR_DB})")
    return results


def music_train_state(dev) -> TrainState:
    cfg = {**MUSIC_CFG, "quantization": {**MUSIC_CFG["quantization"], "max_observations": MUSIC_TRAIN_WINDOW}}
    model, teacher = create_model_and_teacher(cfg, generator=torch.Generator().manual_seed(51))
    return new_train_state(model.to(dev), teacher.to(dev))


def music_step_card_vs_cpu(dev, step, state: TrainState, src: np.ndarray, cpu_own: bool = False) -> tuple:
    """One KD step from ``state`` on the card, on the CPU and on the card again with the stems times
    (1 + MUSIC_PERTURB), each with the same augmentation draws: (the card's and the CPU's L1 losses apart in dB,
    their whole-gradient cosine, the card's cosine against its own perturbed step); ``cpu_own``: and the CPU's
    cosine against its own perturbed step."""
    out = []
    runs = ((dev, 1.0), (torch.device("cpu"), 1.0), (dev, 1 + MUSIC_PERTURB))
    for device, scale in runs + (((torch.device("cpu"), 1 + MUSIC_PERTURB),) if cpu_own else ()):
        st = new_train_state(copy.deepcopy(state.model).to(device), copy.deepcopy(state.teacher).to(device))
        metrics = step(st, torch.from_numpy(src * np.float32(scale)).to(device), torch.Generator().manual_seed(52))
        grads = torch.cat([p.grad.flatten().double().cpu() for p in st.model.parameters() if p.grad is not None])
        out.append((float(metrics["loss"]), grads))
        del st
    (loss_card, g_card), (loss_cpu, g_cpu), (_, g_own) = out[:3]

    def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
        return float(a @ b / (a.norm() * b.norm()))

    cpu_cos = (cosine(g_cpu, out[3][1]),) if cpu_own else ()
    return abs(10 * math.log10(loss_card / loss_cpu)), cosine(g_card, g_cpu), cosine(g_card, g_own), *cpu_cos


def music_stems(seed: int, batch: int, length: int) -> np.ndarray:
    return synth_music_batch(np.random.default_rng(seed), batch, length, sample_rate=MUSIC_SR)


def music_training(dev, smi: str) -> dict:
    """Phases 51-52: the tasnet KD step at full width (MUSIC_TRAIN_SEG windows, the config's augmentation): the
    peak memory of one step at batch 1, then 8 steps at the largest of 4, 2, 1 that it says fit, each launching the
    module tree's kernels; their time and peak memory; card vs CPU on one step. Returns the run's launches."""
    step = make_music_train_step(TrainConfig(lr=3e-4), MUSIC_AUGMENT)
    gen = torch.Generator().manual_seed(51)
    total = torch.cuda.get_device_properties(dev).total_memory
    state = music_train_state(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step(state, torch.from_numpy(music_stems(51, 1, MUSIC_TRAIN_SEG)).to(dev), gen)
    per_element = torch.cuda.max_memory_allocated(dev) - base
    fits = [b for b in (4, 2, 1) if base + b * per_element <= MUSIC_TRAIN_MEMORY * total]
    batch = fits[0] if fits else 1
    log(f"[51] music KD step 1 x {MUSIC_TRAIN_SEG / MUSIC_SR:g} s: peak {per_element / 1e9:.2f} GB above the "
        f"{base / 1e9:.2f} GB held; batch {batch} fits {MUSIC_TRAIN_MEMORY:.0%} of {total / 1e9:.1f} GB "
        f"(batch 4 would need {(base + 4 * per_element) / 1e9:.1f} GB)")
    del state
    torch.cuda.empty_cache()
    state = music_train_state(dev)
    model, teacher = state.model, state.teacher
    q = count_quantizers(model.modules())
    want = no_launches(act=q["act"], weight=1, act_bwd=q["act"], weight_bwd=1,
                       qmatmul=fused_convs(teacher)["qmatmul"])
    rng_seeds = range(510, 510 + TRAIN_STEPS)
    losses = []
    reset_all_launches()
    t0 = time.perf_counter()
    for i, seed in enumerate(rng_seeds):
        before = all_launches()
        metrics = step(state, torch.from_numpy(music_stems(seed, batch, MUSIC_TRAIN_SEG)).to(dev), gen)
        got = {k: v - before[k] for k, v in all_launches().items()}
        if got != want:
            raise AssertionError(f"music train step {i}: launches {got} != {want}")
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_launches()
    if not np.isfinite(losses).all() or state.skipped:
        raise AssertionError(f"music losses {losses}, skipped {state.skipped}")
    log(f"[51] music KD train at full width, {TRAIN_STEPS} steps of {batch} x {MUSIC_TRAIN_SEG / MUSIC_SR:g} s "
        f"(augmented: shift {MUSIC_AUGMENT['shift']}, signs, channels, gains, remix), observer window "
        f"{MUSIC_TRAIN_WINDOW}, in {seconds:.1f} s: losses {[round(v, 4) for v in losses]}, finite, skipped 0; every "
        f"step launched {', '.join(f'{k}={v}' for k, v in want.items() if v)} (act_bwd = every act quantizer: all "
        f"reach the loss; K3 = the float teacher's {want['qmatmul']} bias-free 1x1 convs, which run without "
        f"gradient)")
    stems = torch.from_numpy(music_stems(52, batch, MUSIC_TRAIN_SEG)).to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(lambda: step(state, stems, gen), 3)
    peak = torch.cuda.max_memory_allocated(dev)
    audio_s = batch * MUSIC_TRAIN_SEG / MUSIC_SR
    log(f"[51] music train step {batch} x {MUSIC_TRAIN_SEG / MUSIC_SR:g} s: {ms:.1f} ms per step, "
        f"{audio_s / (ms / 1000):.2f} sec-audio trained/s; peak memory {peak / 1e9:.2f} GB on {smi}")
    del stems
    after = TrainState(copy.deepcopy(model).cpu(), None, copy.deepcopy(teacher).cpu())
    del state, model, teacher
    torch.cuda.empty_cache()

    # 52. card vs CPU on one post-window step at 1 x 1 s (the same augmentation draws), within the card's own floor
    src = music_stems(52, 1, MUSIC_SR)
    loss_db, cos, own = music_step_card_vs_cpu(dev, step, after, src)
    cos_min = 1 - MUSIC_FLOOR_RULE[1] * (1 - own)
    if not (loss_db <= LOSS_DB_TOL and cos >= cos_min):
        raise AssertionError(f"music card vs CPU train step: loss {loss_db} dB apart (at most {LOSS_DB_TOL}), gradient "
                             f"cosine {cos} (at least {cos_min}: the card's own {own})")
    log(f"[52] music card vs CPU train step at 1 x 1 s: L1 losses {loss_db:.2e} dB apart (<= {LOSS_DB_TOL}), "
        f"whole-gradient cosine {cos:.6f}; the card's own step on the stems times (1 + 2^-22): cosine {own:.6f}; "
        f"card vs CPU within that floor (>= {cos_min:.6f})")
    return {"launches": launches, "batch": batch, "ms": ms, "peak_gb": peak / 1e9}


def music_recipe_epoch() -> None:
    """Phase 53: one epoch of ``python -m fqss_tpu_torch.train -env tasnet`` (on the card, its default) with the
    full-width MUSIC_CFG on a mini MUSDB that ``make_mini_musdb`` writes at MUSIC_SR; the config as JSON."""
    with tempfile.TemporaryDirectory() as tmp:
        root = make_mini_musdb(os.path.join(tmp, "musdb"), n_train=2, n_test=1, sample_rate=MUSIC_SR,
                               seconds=MUSIC_RECIPE_SECONDS)
        conf = {
            "work_dir": os.path.join(tmp, "run"),
            "model_cfg": MUSIC_CFG,
            "dataset_cfg": {"name": "musdbhq", "musdb_root": root, "metadata_file": os.path.join(tmp, "musdb.json"),
                            "sample_rate": MUSIC_SR, "segment": 1, "data_stride": 1, "augmentation": MUSIC_AUGMENT},
            "training_cfg": {"epochs": 1, "batch_size": 1, "kd_lambda": 0.1, "seed": 42,
                             "optim": {"optimizer": "adam", "lr": 0.0003, "weight_decay": 0.0}},
            "testing_cfg": {"test_dir": root, "NSDR": True, "segment_samples": MUSIC_SEG, "overlap": 0.25},
        }
        path = os.path.join(tmp, "convtasnet_music.json")
        with open(path, "w") as fh:
            json.dump(conf, fh)
        env_vars = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "fqss_tpu_torch.train", "-env", "tasnet", "-y", path], cwd=tmp,
                              env=env_vars, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0 or "Training done" not in proc.stdout:
            raise AssertionError(f"music recipe epoch failed ({proc.returncode}):\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        for out in ("best_model.pt", "latest_model.pt", "checkpoints/epoch_0.pt", "history.json"):
            if not os.path.exists(os.path.join(tmp, "run", out)):
                raise AssertionError(f"music recipe epoch wrote no {out}")
        with open(os.path.join(tmp, "run", "history.json")) as fh:
            history = json.load(fh)
        with open(os.path.join(tmp, "run", "results.txt")) as fh:
            test_line = [line for line in fh.read().splitlines() if line.startswith("test epoch")]
        if not np.isfinite([history[0]["loss"], history[0]["valid_nsdr"]]).all() or not test_line:
            raise AssertionError(f"music recipe epoch: history {history}, test lines {test_line}")
    log(f"[53] python -m fqss_tpu_torch.train -env tasnet with MUSIC_CFG at full width: one epoch of 1 s windows of "
        f"a {MUSIC_RECIPE_SECONDS:g} s track, a validation track and the test track's NSDR in {seconds:.1f} s (the "
        f"process included): train loss {history[0]['loss']:.4f}, valid NSDR {history[0]['valid_nsdr']:.3f} dB; "
        f"{test_line[-1]}")


def serve_music(dev, smi: str) -> dict:
    """Phases 44-52, the ConvTasNet-music slice but its recipe epoch (53, run beside phase 64's); returns what the
    kernels line needs."""
    launches, k3_shapes, k4_sites, throughput, state = music_forwards(dev, smi)  # 44-48.
    torch.cuda.empty_cache()
    clock("44-48")
    qmm, k4 = music_kernels(dev, k3_shapes)  # 49.
    clock("49")
    music_evaluation(dev, state)  # 50.
    torch.cuda.empty_cache()
    clock("50")
    train = music_training(dev, smi)  # 51-52.
    clock("51-52")
    return {"launches": launches, "k4_launches": k4_sites, "qmm": qmm, "k4": k4, "train": train,
            "throughput": throughput, "state": state}


def htdemucs_mix(seed: int, batch: int, length: int) -> np.ndarray:
    """Stereo mixtures [B, 2, T]: the sums of seeded synthetic stems (``synth_music_batch``) at HTD_SR."""
    return synth_music_batch(np.random.default_rng(seed), batch, length, sample_rate=HTD_SR).sum(axis=1)


def build_served_htdemucs(dev, **arch) -> HTDemucs:
    """The full-width HTDemucs of HTDEMUCS_CFG (``arch``: model_cfg keys that change its depth) from a seeded
    generator, its ranges from the config's observer window over HTD_OBSERVE's stems (train=True, their own length
    the segment), returned in eval() mode with the observer off."""
    batch, length, steps = HTD_OBSERVE
    cfg = {**HTDEMUCS_CFG, **arch}
    model = create_model(cfg, generator=torch.Generator().manual_seed(54)).to(dev).train()
    if model.q.max_observations != steps:
        raise AssertionError(f"the config's observer window is {model.q.max_observations} steps, not {steps}")
    x = torch.from_numpy(htdemucs_mix(54, batch, length)).to(dev)
    with torch.no_grad():
        for _ in range(steps):
            model(x)
    served = create_model(cfg, dataclasses.replace(model.q, observer=False))
    served.load_state_dict(model.state_dict())
    return served.to(dev).eval()


def htdemucs_on_cpu(served: HTDemucs, **arch) -> HTDemucs:
    """The served model on the CPU: the same weights and ranges, in eval() mode."""
    cpu_model = create_model({**HTDEMUCS_CFG, **arch}, served.q)
    cpu_model.load_state_dict(state_on_cpu(served))
    return cpu_model.eval()


def htdemucs_serving_launches(model: HTDemucs) -> dict:
    """A serving forward's launches: K1 per act quantizer module but the QDense layers' (K5 applies their grids) and
    each attention's no-op sites (off in eval()) and head site (K8's epilogue applies it), one grouped weight launch,
    K5 per QDense (linear1 on its GELU route), K8 per attention."""
    attn = sum(isinstance(m, QMultiheadAttention) for m in model.modules())
    dense, gelu = dense_quantizers(model), sum(isinstance(m, QDense) and m.gelu for m in model.modules())
    return no_launches(act=count_quantizers(model.modules())["act"] - dense["act"] - 3 * attn, weight=1,
                       dense=dense["dense"] - gelu, dense_gelu=gelu, attention=attn)


def htdemucs_int8_launches(model: HTDemucs, bf16: bool) -> tuple[dict, int]:
    """The int8 engine's launches: K1 per act quantizer of the folded conv branches (the transformer block's grids
    are the engine's requantizations), K4 per transformer projection (self-attention layers: the in-projection, the
    out-projection, linear1, linear2; cross-attention layers: Q and K/V apart) and channel sampler, K8 per attention
    (its bf16 route in bf16); and the K4 launches with the GELU epilogue (every linear1)."""
    block = ("crosstransformer", "channel_upsampler", "channel_downsampler")
    act = sum(isinstance(m, ActQuantizer) for n, m in model.named_modules() if not n.startswith(block))
    layers = [layer for pair in model.crosstransformer.layers for layer in pair]
    sites = sum(5 if hasattr(layer, "cross_attn") else 4 for layer in layers) + (4 if model.bottom_channels else 0)
    attention = "attention_bf16" if bf16 else "attention"
    return no_launches(act=act, int8_mm=sites, **{attention: len(layers)}), len(layers)


def record_htdemucs_shapes(model: HTDemucs) -> tuple[list, list]:
    """Hooks on ``model``'s attention and QDense layers that record, per call, ("attention", B, Lq, Lk, E, heads),
    ("dense", M, K, N, gelu) and each projection of an attention, ("projection", M, K, N); returns the list and the
    hooks' handles."""
    seen = []

    def attention(mod, args):
        seen.append(("attention", args[0].shape[0], args[0].shape[1], args[1].shape[1], mod.embed_dim, mod.num_heads))

    def dense(mod, args):
        seen.append(("dense", args[0].numel() // args[0].shape[-1], *mod.weight.shape[::-1], mod.gelu))

    handles = [m.register_forward_pre_hook(attention if isinstance(m, QMultiheadAttention) else dense)
               for m in model.modules() if isinstance(m, (QMultiheadAttention, QDense))]
    handles += record_projections(model, lambda x, w: seen.append(("projection", x.numel() // x.shape[-1],
                                                                   *w.shape[::-1])))
    return seen, handles


def htdemucs_attention_shapes(records: list) -> list[tuple]:
    """(name, BH, Lq, Lk, d, launches per forward, model, heads) of a forward's attention calls, as phase 24 takes
    them."""
    calls = [r[1:] for r in records if r[0] == "attention"]
    shapes = []
    for (b, lq, lk, e, h), n in ((c, calls.count(c)) for c in dict.fromkeys(calls)):
        kind = "self" if lq == lk else "cross"
        shapes.append((f"HTDemucs {kind} {lq} x {lk}", b * h, lq, lk, e // h, n, "HTDemucs", h))
    return shapes


def htdemucs_int8_cases(records: list, gelu: bool) -> list[tuple]:
    """(M, K, N, nl, alpha, grids, what, launches per forward) of the int8 engine's K4 launches at a forward's
    attention and QDense shapes: each self-attention's in-projection (three output grids) and each cross-attention's
    Q and K/V in-projections (one and two grids), every out-projection, linear2 (``gelu`` False) or linear1, with the
    GELU (``gelu``)."""
    one, calls = (INT8_TIE_DELTA, INT8_TIE_MN), []
    for r in records:
        if r[0] == "dense" and r[4] == gelu:
            calls.append((r[1], r[2], r[3], "gelu" if gelu else "prelu", 1.0, one, "linear1" if gelu else "linear2"))
        elif r[0] == "attention" and not gelu:
            b, lq, lk, e, _ = r[1:]
            if lq == lk:
                calls.append((b * lq, e, 3 * e, "prelu", 1.0, QKV_GRIDS, "self-attention in-projection"))
            else:
                calls += [(b * lq, e, e, "prelu", 1.0, one, "cross-attention Q projection"),
                          (b * lk, e, 2 * e, "prelu", 1.0, ([INT8_TIE_DELTA, 0.013], [INT8_TIE_MN, -2.5]),
                           "cross-attention K/V projection (two output grids)")]
            calls.append((b * lq, e, e, "prelu", 1.0, one, "out-projection"))
    keyed = [(c, tuple(map(str, c))) for c in calls]
    unique = dict.fromkeys(k for _, k in keyed)
    return [(*next(c for c, kk in keyed if kk == k), sum(kk == k for _, kk in keyed)) for k in unique]


def htdemucs_forwards(dev, smi: str) -> dict:
    """Phases 54-58, the HTDemucs serving path at full width: the fake-quant forward, card vs CPU, folded, the int8
    engines, throughput and peak memory. Returns what phase 59 and the kernels line need."""
    served = build_served_htdemucs(dev)
    x = torch.from_numpy(htdemucs_mix(55, HTD_BATCH, HTD_SEG)).to(dev)
    n_params = sum(p.numel() for n, p in served.named_parameters() if "fake_quantize" not in n)
    want = htdemucs_serving_launches(served)
    records, handles = record_htdemucs_shapes(served)
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        y = served(x, train=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = all_launches()
    for h in handles:
        h.remove()
    shape = (HTD_BATCH, served.n_srcs, served.audio_channels, HTD_SEG)
    if tuple(y.shape) != shape or not torch.isfinite(y).all():
        raise AssertionError(f"HTDemucs forward gave shape {tuple(y.shape)}, finite={bool(torch.isfinite(y).all())}")
    if launches != want:
        raise AssertionError(f"HTDemucs forward launches {launches} != {want}")
    attn_shapes = htdemucs_attention_shapes(records)
    log(f"[54] HTDemucs at full width ({n_params} parameters; ranges from the config's {HTD_OBSERVE[2]}-step observer "
        f"window over {HTD_OBSERVE[0]} x {HTD_OBSERVE[1]} stereo samples): {tuple(x.shape)} (train=False: padded to "
        f"{int(served.segment * served.samplerate)}) -> {tuple(y.shape)}, finite, first call {first_s:.2f} s, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{', '.join(f'{k}={v}' for k, v in launches.items() if v)} (K1 = act quantizers but the QDense layers' and "
        f"the attentions' no-op and head sites, one grouped weight launch, K5 = linear2, K5-gelu = linear1, K8 = the "
        f"attentions: " + "; ".join(f"{s[0]} BH {s[1]} d {s[4]} x{s[5]}" for s in attn_shapes) + "), all others 0")

    # 55. at full depth the card's own floor on one chunk (phase 57 holds the int8 engines to it); card vs CPU at
    # HTD_SHALLOW, >= 20 dB
    x1 = x[:1]
    with torch.inference_mode():
        y_card, y_own = served(x1, train=False).cpu(), served(x1 * (1 + MUSIC_PERTURB), train=False).cpu()
    own, lsb = snr_db(y_card, y_own), htdemucs_out_step(served)
    floor = (own.min().item(), (y_own - y_card).abs().mean().item() / lsb)
    log(f"[55] HTDemucs at full depth, the card against itself on one chunk {tuple(x1.shape)} times (1 + 2^-22): "
        f"{own.min().item():.2f}-{own.max().item():.2f} dB, mean {floor[1]:.4f} output steps (the floor of phase 57)")
    shallow = build_served_htdemucs(dev, **HTD_SHALLOW)
    cpu_model = htdemucs_on_cpu(shallow, **HTD_SHALLOW)
    with torch.inference_mode():
        y_card = shallow(x1, train=False).cpu()
        t0 = time.perf_counter()
        y_cpu = cpu_model(x1.cpu(), train=False)
        cpu_s = time.perf_counter() - t0
    snr = snr_db(y_cpu, y_card)
    if not bool((snr >= 20).all()):
        raise AssertionError(f"HTDemucs card vs CPU at {HTD_SHALLOW}: SNR {snr.tolist()} dB < 20 dB")
    log(f"[55] the same width at {HTD_SHALLOW}: card vs CPU SNR {snr.min().item():.2f}-{snr.max().item():.2f} dB "
        f"(>= 20; the CPU's forward {cpu_s:.1f} s)")
    del y_own

    # 56. folded
    folded = fold_quantized_weights(served)
    reset_all_launches()
    with torch.inference_mode():
        y_folded = folded(x, train=False)
    torch.cuda.synchronize()
    if all_launches() != {**want, "weight": 0} or not torch.equal(y_folded, y):
        raise AssertionError(f"HTDemucs folded: launches {all_launches()}, max |diff| {(y_folded - y).abs().max()}")
    log(f"[56] HTDemucs folded engine: bitwise equal to fake-quant; no weight-kernel launch, K5 {want['dense']} + "
        f"{want['dense_gelu']} GELU with their weight grids off, K8 {want['attention']}")
    del y_folded

    # 57. the int8 engines: launches = the module tree's, the floor rule against fake-quant, card vs CPU
    engines, gelu_launches, int8_launches = {}, {}, {}
    for dtype, (snr_margin, mean_factor) in INT8_FLOOR.items():
        engine = engines[dtype] = make_int8_engine(served, compute_dtype=dtype)
        want8, layers = htdemucs_int8_launches(served, dtype == "bfloat16")
        reset_all_launches()
        with torch.inference_mode():
            y8 = engine(x, train=False)
        torch.cuda.synchronize()
        got, gelu_launches[dtype] = all_launches(), im.GELU_LAUNCHES["int8_mm"]
        int8_launches[dtype] = got
        if got != want8 or gelu_launches[dtype] != layers:  # every layer's linear1
            raise AssertionError(f"HTDemucs int8 engine ({dtype}) launches {got} ({gelu_launches[dtype]} with the "
                                 f"GELU) != {want8}")
        diff = (y8 - y).abs()
        snr8, mean_lsb = snr_db(y, y8), diff.mean().item() / lsb
        snr_min, mean_max = floor[0] - snr_margin, floor[1] * mean_factor
        if snr8.min().item() < snr_min or mean_lsb > mean_max or not torch.isfinite(y8).all():
            raise AssertionError(f"HTDemucs int8 engine ({dtype}) vs fake-quant: SNR {snr8.min().item():.2f} dB "
                                 f"(minimum {snr_min:.2f}), mean {mean_lsb:.3f} output steps (maximum {mean_max:.3f})")
        log(f"[57] HTDemucs int8 engine ({dtype} float products) {tuple(x.shape)}: finite; launches "
            f"{', '.join(f'{k}={v}' for k, v in got.items() if v)} ({gelu_launches[dtype]} K4 launches with the GELU "
            f"epilogue), all others 0; vs fake-quant SNR {snr8.min().item():.2f}-{snr8.max().item():.2f} dB (>= "
            f"{snr_min:.2f}, phase 55's floor), mean {mean_lsb:.4f} output steps (<= {mean_max:.3f}), max "
            f"{diff.max().item() / lsb:.2f}")
        del y8, diff
    t0 = time.perf_counter()
    for dtype in INT8_CARD_VS_CPU:  # at HTD_SHALLOW, within the engine's own floor there
        engine = make_int8_engine(shallow, compute_dtype=dtype)
        with torch.inference_mode():
            y_card = engine(x1, train=False).cpu()
            y_own = engine(x1 * (1 + MUSIC_PERTURB), train=False).cpu()
            y_cpu = make_int8_engine(cpu_model, compute_dtype=dtype)(x1.cpu(), train=False)
        snr8, own = snr_db(y_cpu, y_card), snr_db(y_card, y_own)
        step_s = htdemucs_out_step(shallow)
        mean8 = (y_card - y_cpu).abs().mean().item() / step_s
        own_mean = (y_own - y_card).abs().mean().item() / step_s
        snr_min, mean_max = own.min().item() - MUSIC_FLOOR_RULE[0], own_mean * MUSIC_FLOOR_RULE[1]
        if snr8.min().item() < snr_min or mean8 > mean_max:
            raise AssertionError(f"HTDemucs int8 engine ({dtype}) card vs CPU: SNR {snr8.tolist()} dB (minimum "
                                 f"{snr_min:.2f}), mean {mean8:.3f} output steps (maximum {mean_max:.3f})")
        log(f"[57] HTDemucs int8 engine ({dtype}) card vs CPU on one chunk at {HTD_SHALLOW}: SNR "
            f"{snr8.min().item():.2f}-{snr8.max().item():.2f} dB, mean {mean8:.4f} output steps; the card against "
            f"itself on the input times (1 + 2^-22): {own.min().item():.2f}-{own.max().item():.2f} dB, mean "
            f"{own_mean:.4f}: within that floor (SNR >= {snr_min:.2f}, mean <= {mean_max:.3f})")
    log(f"[57] the two engines' card-vs-CPU runs in {time.perf_counter() - t0:.1f} s")
    del cpu_model, shallow, engine

    # 58. throughput and peak memory of every engine
    audio_s = HTD_BATCH * HTD_SEG / HTD_SR
    throughput = {}
    for name, engine in (("fake_quant", served), ("folded", folded), ("int8 float32", engines["float32"]),
                         ("int8 bfloat16", engines["bfloat16"])):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2**30  # the four engines' weights, the input, phase 54's output
        with torch.inference_mode():
            ms = cuda_ms(lambda: engine(x, train=False), 3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        throughput[name] = {"ms": ms, "peak_gib": peak}
        log(f"[58] HTDemucs throughput {name}: {audio_s / (ms / 1000):.1f} sec-audio/s ({ms:.1f} ms per forward of "
            f"{HTD_BATCH} x {HTD_SEG / HTD_SR:g} s stereo, padded to 10 s), peak memory {peak:.2f} GiB of which "
            f"{resident:.2f} resident before the forwards, on {smi}")
    return {"launches": launches, "records": records, "attn_shapes": attn_shapes, "throughput": throughput,
            "int8_launches": int8_launches["float32"], "gelu_launches": gelu_launches["float32"],
            "state": state_on_cpu(served)}


def htdemucs_out_step(model: HTDemucs) -> float:
    """The output grid's step of the last frequency decoder (the combiner's first plane)."""
    aq = model.decoders[-1].conv_tr.activation_fake_quantize
    return (aq.max_range - aq.min_range).item() / 255


def check_htdemucs_dense(dev, records: list) -> tuple[dict, dict]:
    """Phase 59 (K5): linear2 and the attentions' projections on K5 and linear1 on its GELU route against their
    plain versions at a forward's shapes, every grid and observing-flag combination with planted ties (phase 31's
    rules; the GELU route's bound GELU_SLOPE times its pre-GELU one); times per forward of the serving call (QDense:
    the act grid on, the weight grid off, the weight pass's; a projection: both off), the plain version and the
    library call (addmm [+ F.gelu] [+ K1])."""
    gen = torch.Generator(device=dev).manual_seed(59)
    calls = [(*r[1:], "linear1" if r[4] else "linear2") for r in records if r[0] == "dense"]
    calls += [(*r[1:], False, "projection") for r in records if r[0] == "projection"]
    results = {g: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "launches": 0, "moved": 0,
                   "ops": 0} for g in (False, True)}
    for (m, k, n, gelu, what), count in ((c, calls.count(c)) for c in dict.fromkeys(calls)):
        case = dense_case(dev, m, k, n, gen)
        res = results[gelu]
        for flags in DENSE_FLAGS:
            res["max_abs_err"] = max(res["max_abs_err"], check_dense_forward(f"HTDemucs [{m},{k}]x[{n},{k}] {flags}",
                                                                             dense_args(case, flags), gelu=gelu))
        x, w, b, _, _, a_mn, a_mx = case
        if what == "projection":
            a_mn = a_mx = None
        act = (lambda v: F.gelu(v)) if gelu else (lambda v: v)
        grid = (lambda v: v) if a_mn is None else (lambda v: fq.act_fake_quant(v, a_mn, a_mx, 8))
        ms = cuda_ms(lambda: qd.qat_dense(x, w, b, a_mn=a_mn, a_mx=a_mx, gelu=gelu), 10)
        plain = cuda_ms(lambda: qd.qat_dense_ref(x, w, b, a_mn=a_mn, a_mx=a_mx, gelu=gelu), 10)
        lib = cuda_ms(lambda: grid(act(torch.addmm(b, x, w.t()))), 10)
        # the GELU's cost: the same call without it
        plain_route = cuda_ms(lambda: qd.qat_dense(x, w, b, a_mn=a_mn, a_mx=a_mx), 10) if gelu else ms
        res["no_gelu_ms"] = res.get("no_gelu_ms", 0.0) + count * plain_route
        (fb, fo), _ = dense_bounds(m, k, n)
        log(f"[59] K5{' GELU route' if gelu else ''} at HTDemucs's {what} [{m},{k}] x "
            f"[{n},{k}]: every grid and observing-flag combination ({len(DENSE_FLAGS)}) within its bounds, planted ties "
            f"and clip extremes included; {ms:.4f} ms ({rate_and_shares(fb, fo, ms)}), plain {plain:.4f}, addmm"
            f"{' + F.gelu' if gelu else ''}{'' if a_mn is None else ' + K1'} {lib:.4f}"
            f"{f', K5 without the GELU at this shape {plain_route:.4f}' if gelu else ''}; {count} a forward")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("moved", fb), ("ops", fo)):
            res[key] += count * val
        res["launches"] += count
        del case, x, w
    for gelu, res in results.items():
        res.update(bound_of(res["moved"], res["ops"], F32_OPS_S), **route_bound(res["moved"], res["ops"]))
        without = f", without the GELU {res['no_gelu_ms']:.3f}" if gelu else ""
        log(f"[59] one HTDemucs forward's {res['launches']} K5{' GELU route' if gelu else ''} launches: "
            f"{res['ms']:.3f} ms ({rate_and_shares(res['moved'], res['ops'], res['ms'])}), plain {res['plain_ms']:.3f}, "
            f"library {res['library_ms']:.3f}{without}")
    return results[False], results[True]


def check_htdemucs_int8(dev, records: list) -> tuple[dict, dict]:
    """Phase 59 (K4): bitwise against its plain version at the int8 engine's shapes (phase 22's rule), the GELU
    epilogue apart; per forward, with torch._int_mm's time (the product alone) beside them."""
    out = []
    for gelu in (False, True):
        cases = htdemucs_int8_cases(records, gelu)
        res = check_int8_cases(dev, 59, f"HTDemucs{' GELU' if gelu else ''}", cases, 59 + gelu, plain=True)
        gen = torch.Generator(device=dev).manual_seed(60)
        res["int_mm_ms"] = res["no_gelu_ms"] = 0.0
        for m, k, n, *_, count in cases:
            xs, w, scale, corr = int8_case(dev, m, k, n, gen)
            wt = w.t()
            res["int_mm_ms"] += count * cuda_ms(lambda: torch._int_mm(xs, wt), 10)
            if gelu:  # the GELU's cost: the same launch with the identity epilogue
                args = (xs, w, scale * 0.05, corr, 1.0, INT8_TIE_DELTA, INT8_TIE_MN)
                res["no_gelu_ms"] += count * cuda_ms(lambda: im.int8_matmul_requant(*args), 10)
        log(f"[59] torch._int_mm at the same shapes, the product alone: {res['int_mm_ms']:.3f} ms a forward"
            + (f"; K4 with the identity epilogue there {res['no_gelu_ms']:.3f} ms" if gelu else ""))
        out.append(res)
    return out[0], out[1]


def htdemucs_evaluation(dev, state: dict) -> dict:
    """Phase 60: ``python -m fqss_tpu_torch.val`` (MUSDB NSDR) with the fake_quant and int8 engines, each in its own
    process on the card (the two at once), on a MUSDB-layout test split of two 12 s tracks of synthetic stems at HTD_SR, the model
    centre-padding each chunk to segment_samples."""
    stems = synth_music_batch(np.random.default_rng(60), 2, 12 * HTD_SR, sample_rate=HTD_SR)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, track in enumerate(stems):
            d = os.path.join(tmp, "test", f"track_{i}")
            save_audio(os.path.join(d, "mixture.wav"), np.clip(track.sum(0), -0.99, 0.99), HTD_SR)
            for s, name in enumerate(HTDEMUCS_CFG["sources"]):
                save_audio(os.path.join(d, f"{name}.wav"), track[s], HTD_SR)
        ckpt = os.path.join(tmp, "htdemucs_fqss8bit.pt")
        torch.save(state, ckpt)
        cfg = os.path.join(tmp, "htdemucs.json")
        with open(cfg, "w") as f:
            json.dump({"model_cfg": {**HTDEMUCS_CFG, "model_path": ckpt}, "dataset_cfg": {"name": "musdbhq"},
                       "testing_cfg": {"test_dir": tmp, "NSDR": True, "segment_samples": HTD_SEG, "overlap": 0.25}}, f)
        def run(engine: str) -> None:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "fqss_tpu_torch.val", "-y", cfg, "--engine", engine],
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"val --engine {engine} failed: {proc.stderr[-2000:]}")
            line = proc.stdout.strip().splitlines()[-1]
            results[engine] = {k.lower(): float(v) for k, v in (kv.split("=") for kv in line.split(","))}
            log(f"[60] python -m fqss_tpu_torch.val --engine {engine} (MUSDB NSDR over 2 synthetic tracks of 12 s, "
                f"on the card, the two processes side by side): {line} in {time.perf_counter() - t0:.1f} s")

        side_by_side(lambda: run("fake_quant"), lambda: run("int8"))
    for engine, m in results.items():
        if not np.isfinite(list(m.values())).all():
            raise AssertionError(f"HTDemucs evaluation of {engine}: non-finite metrics {m}")
    gap = abs(results["int8"]["nsdr"] - results["fake_quant"]["nsdr"])
    if gap > EVAL_NSDR_DB:
        raise AssertionError(f"HTDemucs int8 mean NSDR {gap:.3f} dB from fake_quant's (bound {EVAL_NSDR_DB})")
    log(f"[60] HTDemucs int8 vs fake_quant mean NSDR: {gap:.4f} dB apart (<= {EVAL_NSDR_DB})")
    return results


def serve_htdemucs(dev, smi: str) -> dict:
    """Phases 54-60, the HTDemucs serving slice; returns what the kernels line needs."""
    out = htdemucs_forwards(dev, smi)  # 54-58.
    torch.cuda.empty_cache()
    records = out["records"]
    out["attn"] = check_attention_kernel(dev, out["attn_shapes"], phase=59, models=("HTDemucs",), odd=False)  # 59.
    torch.cuda.empty_cache()
    out["attn16"] = check_bf16_attention(dev, out["attn_shapes"], phase=59, models=("HTDemucs",), odd=False)
    torch.cuda.empty_cache()
    out["k5"], out["k5_gelu"] = check_htdemucs_dense(dev, records)
    out["k4"], out["k4_gelu"] = check_htdemucs_int8(dev, records)
    torch.cuda.empty_cache()
    htdemucs_evaluation(dev, out["state"])  # 60.
    return out


def htdemucs_train_state(dev, cfg: TrainConfig) -> TrainState:
    """A full-width HTDemucs student and its float teacher from HTDEMUCS_CFG (observer window MUSIC_TRAIN_WINDOW) on
    the card, with the recipe's optimizer (``make_music_optimizer``: the config sets no group of its own)."""
    model_cfg = {**HTDEMUCS_CFG,
                 "quantization": {**HTDEMUCS_CFG["quantization"], "max_observations": MUSIC_TRAIN_WINDOW}}
    model, teacher = create_model_and_teacher(model_cfg, generator=torch.Generator().manual_seed(62))
    model, teacher = model.to(dev), teacher.to(dev)
    return TrainState(model, make_music_optimizer(cfg, model_cfg, model), teacher)


def htdemucs_train_launches(model: HTDemucs, teacher: HTDemucs) -> dict:
    """One htdemucs KD step's launches: phase 33's (train_launches) with the QDense layers split into linear2 on K5
    and K5-bwd and linear1 on the GELU routes of both; no K3 (no bias-free 1x1 conv)."""
    want = train_launches(model, teacher)
    gelu = sum(isinstance(m, QDense) and m.gelu for m in model.modules())
    t_gelu = sum(isinstance(m, QDense) and m.gelu for m in teacher.modules())
    return {**want, "dense": want["dense"] - gelu - t_gelu, "dense_gelu": gelu + t_gelu,
            "dense_mask": want["dense_mask"] - gelu, "dense_mask_gelu": gelu}


def check_gelu_backward(dev, shapes: list[tuple]) -> dict:
    """Phase 61: K5-bwd's GELU route against its plain version at ``shapes`` ((m, k, n, launches a step)), every
    grid and observing-flag combination with planted ties (phase 31's backward rules, the bounds GELU_SLOPE times
    larger); times a step of the call as the step makes it (the weight pass's grid: the weight grid off; the act
    grid on, its window closed), of the plain version and of the library call: two torch.mm, torch's GELU backward
    and K1-bwd on the forward's saved pre-activation and GELU output."""
    gen = torch.Generator(device=dev).manual_seed(61)
    res = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "launches": 0, "moved": 0, "ops": 0}
    for m, k, n, count in shapes:
        case = dense_case(dev, m, k, n, gen)
        g = torch.randn(m, n, device=dev, generator=gen)
        for flags in DENSE_FLAGS:
            res["max_abs_err"] = max(res["max_abs_err"], check_dense_backward(
                f"GELU route [{m},{k}]x[{n},{k}] {flags}", dense_args(case, flags), g, gelu=True))
        x, w, b, _, _, a_mn, a_mx = case
        closed = torch.tensor(False, device=dev)
        pre = torch.addmm(b, x, w.t())
        u = F.gelu(pre)
        ms = cuda_ms(lambda: qd.qat_dense_bwd(x, w, b, g, a_mn=a_mn, a_mx=a_mx, a_observing=closed, gelu=True), 10)
        plain = cuda_ms(lambda: qd.qat_dense_bwd_ref(x, w, b, g, a_mn=a_mn, a_mx=a_mx, a_observing=closed,
                                                     gelu=True), 10)

        def library():
            gm = torch.ops.aten.gelu_backward(fq.act_fake_quant_bwd(u, g, a_mn, a_mx, 8)[0], pre)
            return gm @ w, gm.t() @ x

        lib = cuda_ms(library, 10)
        _, (bb, bo) = dense_bounds(m, k, n)
        log(f"[61] K5-bwd GELU route at linear1's training shape [{m},{k}] x [{n},{k}]: every grid and observing-flag "
            f"combination ({len(DENSE_FLAGS)}) within its bounds, planted ties and clip extremes included; "
            f"{ms:.4f} ms ({rate_and_shares(bb, bo, ms)}), plain {plain:.4f}, two mm + gelu_backward + K1-bwd "
            f"{lib:.4f}; {count} a step")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("moved", bb), ("ops", bo)):
            res[key] += count * val
        res["launches"] += count
        del case, g, x, w, pre, u
        torch.cuda.empty_cache()
    res.update(bound_of(res["moved"], res["ops"], F32_OPS_S), **route_bound(res["moved"], res["ops"]))
    log(f"[61] one htdemucs step's {res['launches']} K5-bwd GELU-route launches: {res['ms']:.3f} ms "
        f"({rate_and_shares(res['moved'], res['ops'], res['ms'])}), plain {res['plain_ms']:.3f}, library "
        f"{res['library_ms']:.3f}")
    return res


def htdemucs_training(dev, smi: str) -> dict:
    """Phases 61-63: the htdemucs KD step at full width (HTD_TRAIN_SEG windows, the config's augmentation, exp loss,
    batch EMA): batch 1's peak memory and linear1's token counts, the GELU route's backward at those shapes (61),
    8 steps at the largest of 4, 2, 1 that fits, each launching the module tree's kernels, their time and peak
    memory (62), card vs CPU on one step (63). Returns the run's launches and phase 61's results."""
    cfg = TrainConfig(lr=3e-4, grad_clip=0.0)
    step = make_music_train_step(cfg, HTD_AUGMENT, weight_kind="exp", is_htdemucs=True,
                                 source_weights=np.ones(len(HTDEMUCS_CFG["sources"]), np.float32),
                                 batch_ema_decays=HTD_EMA)
    gen = torch.Generator().manual_seed(62)
    total = torch.cuda.get_device_properties(dev).total_memory
    state = htdemucs_train_state(dev, cfg)
    emas = [_params_copy(state.model) for _ in HTD_EMA]
    records, handles = record_htdemucs_shapes(state.model)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step(state, torch.from_numpy(music_stems(62, 1, HTD_TRAIN_SEG)).to(dev), gen, emas)
    per_element = torch.cuda.max_memory_allocated(dev) - base
    for h in handles:
        h.remove()
    fits = [b for b in (4, 2, 1) if base + b * per_element <= MUSIC_TRAIN_MEMORY * total]
    batch = fits[0] if fits else 1
    log(f"[62] htdemucs KD step 1 x {HTD_TRAIN_SEG / HTD_SR:g} s: peak {per_element / 1e9:.2f} GB above the "
        f"{base / 1e9:.2f} GB held; batch {batch} fits {MUSIC_TRAIN_MEMORY:.0%} of {total / 1e9:.1f} GB "
        f"(batch 4 would need {(base + 4 * per_element) / 1e9:.1f} GB)")
    del state, emas
    torch.cuda.empty_cache()

    # 61. the GELU route's backward at linear1's shapes of a step at that batch (the student's calls)
    calls = [r[1:4] for r in records if r[0] == "dense" and r[4]]
    shapes = [(batch * m, k, n, calls.count((m, k, n))) for m, k, n in dict.fromkeys(calls)]
    gelu_bwd = check_gelu_backward(dev, shapes)

    # 62. 8 steps at that batch, every step's launches as the module tree says
    state = htdemucs_train_state(dev, cfg)
    model, teacher = state.model, state.teacher
    emas = [_params_copy(model) for _ in HTD_EMA]
    want = htdemucs_train_launches(model, teacher)
    losses = []
    reset_all_launches()
    t0 = time.perf_counter()
    for i, seed in enumerate(range(620, 620 + TRAIN_STEPS)):
        before = all_launches()
        metrics = step(state, torch.from_numpy(music_stems(seed, batch, HTD_TRAIN_SEG)).to(dev), gen, emas)
        got = {k: v - before[k] for k, v in all_launches().items()}
        if got != want:
            raise AssertionError(f"htdemucs train step {i}: launches {got} != {want}")
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = all_launches()
    ema_moved = max((emas[0][n] - p.detach()).abs().max().item() for n, p in model.named_parameters())
    if not np.isfinite(losses).all() or state.skipped or not ema_moved > 0:
        raise AssertionError(f"htdemucs losses {losses}, skipped {state.skipped}, EMA distance {ema_moved}")
    log(f"[62] htdemucs KD train at full width, {TRAIN_STEPS} steps of {batch} x {HTD_TRAIN_SEG / HTD_SR:g} s "
        f"(augmented: shift {HTD_AUGMENT['shift']}, signs, channels, gains, remix in groups of "
        f"{HTD_AUGMENT['remix_group_size']}; exp loss, batch EMA {HTD_EMA[0]}), observer window {MUSIC_TRAIN_WINDOW}, "
        f"in {seconds:.1f} s: losses {[round(v, 4) for v in losses]}, finite, skipped 0, the EMA {ema_moved:.2e} from "
        f"the model at most; every step launched {', '.join(f'{k}={v}' for k, v in want.items() if v)} (K5 and the "
        f"GELU route's forward and K8 for student and teacher; no K1-bwd at the attentions' two no-op sites each)")
    stems = torch.from_numpy(music_stems(63, batch, HTD_TRAIN_SEG)).to(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(lambda: step(state, stems, gen, emas), 3)
    peak = torch.cuda.max_memory_allocated(dev)
    audio_s = batch * HTD_TRAIN_SEG / HTD_SR
    log(f"[62] htdemucs train step {batch} x {HTD_TRAIN_SEG / HTD_SR:g} s: {ms:.1f} ms per step, "
        f"{audio_s / (ms / 1000):.2f} sec-audio trained/s; peak memory {peak / 1e9:.2f} GB on {smi}")
    del stems, emas
    after = TrainState(copy.deepcopy(model).cpu(), None, copy.deepcopy(teacher).cpu())
    del state, model, teacher
    torch.cuda.empty_cache()

    # 63. card vs CPU on one post-window step at 1 x 1 s (the same augmentation draws), within the two devices' own
    # floors (the note above HTD_RECIPE_SECONDS)
    t0 = time.perf_counter()
    loss_db, cos, own, cpu_own = music_step_card_vs_cpu(dev, step, after, music_stems(64, 1, HTD_SR), cpu_own=True)
    cos_min = 1 - MUSIC_FLOOR_RULE[1] * ((1 - own) + (1 - cpu_own))
    if not (loss_db <= LOSS_DB_TOL and cos >= cos_min):
        raise AssertionError(f"htdemucs card vs CPU train step: loss {loss_db} dB apart (at most {LOSS_DB_TOL}), "
                             f"gradient cosine {cos} (at least {cos_min}: the card's own {own}, the CPU's {cpu_own})")
    log(f"[63] htdemucs card vs CPU train step at 1 x 1 s: L1 losses {loss_db:.2e} dB apart (<= {LOSS_DB_TOL}), "
        f"whole-gradient cosine {cos:.7f} (1 - cos {1 - cos:.3e}); each device's own step on the stems times "
        f"(1 + 2^-22): the card's cosine {own:.7f} (1 - cos {1 - own:.3e}), the CPU's {cpu_own:.7f} "
        f"({1 - cpu_own:.3e}); "
        f"card vs CPU within {MUSIC_FLOOR_RULE[1]} x their sum (>= {cos_min:.7f}); {time.perf_counter() - t0:.1f} s")
    htdemucs_shallow_step_card_vs_cpu(dev, cfg, step)
    return {"launches": launches, "batch": batch, "ms": ms, "peak_gb": peak / 1e9, "gelu_bwd": gelu_bwd}


def htdemucs_shallow_step_card_vs_cpu(dev, cfg: TrainConfig, step) -> None:
    """Phase 63's second check: the htdemucs step at HTD_STEP_SHALLOW, card vs CPU against the card's own floor alone
    (phase 52's rule, MUSIC_FLOOR_RULE), after four steps on the card at 1 x 1 s (the window and one more). The rule
    was fixed before its first run, and it does not hold: card vs CPU read 3.8-6.1x the card's own on an H100 (the
    note above HTD_STEP_SHALLOW). The failure stands, so the phase reports the rule's verdict, with the CPU's own
    floor beside it, and raises only where the step is not finite or the losses leave LOSS_DB_TOL."""
    t0 = time.perf_counter()
    model_cfg = {**HTDEMUCS_CFG, **HTD_STEP_SHALLOW,
                 "quantization": {**HTDEMUCS_CFG["quantization"], "max_observations": MUSIC_TRAIN_WINDOW}}
    model, teacher = create_model_and_teacher(model_cfg, generator=torch.Generator().manual_seed(63))
    model, teacher = model.to(dev), teacher.to(dev)
    state = TrainState(model, make_music_optimizer(cfg, model_cfg, model), teacher)
    gen = torch.Generator().manual_seed(63)
    losses = [float(step(state, torch.from_numpy(music_stems(630 + i, 1, HTD_SR)).to(dev), gen)["loss"])
              for i in range(MUSIC_TRAIN_WINDOW + 1)]
    after = TrainState(copy.deepcopy(model).cpu(), None, copy.deepcopy(teacher).cpu())
    del state, model, teacher
    loss_db, cos, own, cpu_own = music_step_card_vs_cpu(dev, step, after, music_stems(64, 1, HTD_SR), cpu_own=True)
    if not (np.isfinite(losses).all() and loss_db <= LOSS_DB_TOL):
        raise AssertionError(f"htdemucs at {HTD_STEP_SHALLOW} card vs CPU train step: losses {losses}, loss "
                             f"{loss_db} dB apart (at most {LOSS_DB_TOL})")
    ratio = (1 - cos) / (1 - own)
    verdict = ("holds" if ratio <= MUSIC_FLOOR_RULE[1] else
               "does not hold (the failure stands: ROADMAP.md queue 3, phase 63's bound)")
    log(f"[63] the same at {HTD_STEP_SHALLOW}: L1 losses {loss_db:.2e} dB apart (<= {LOSS_DB_TOL}), whole-gradient "
        f"cosine {cos:.7f} (1 - cos {1 - cos:.3e}); each device's own step on the stems times (1 + 2^-22): the card's "
        f"cosine {own:.7f} (1 - cos {1 - own:.3e}), the CPU's {cpu_own:.7f} ({1 - cpu_own:.3e}); card vs CPU "
        f"{ratio:.2f} x the card's own: phase 52's rule ({MUSIC_FLOOR_RULE[1]} x the card's own) {verdict}; "
        f"{(1 - cos) / ((1 - own) + (1 - cpu_own)):.2f} x the two own floors' sum; {time.perf_counter() - t0:.1f} s")
    if ratio > MUSIC_FLOOR_RULE[1]:
        standing(f"phase 63's htdemucs step at {HTD_STEP_SHALLOW}, card vs CPU: {ratio:.2f} x the card's own floor "
                 f"(rule {MUSIC_FLOOR_RULE[1]} x)")
    torch.cuda.empty_cache()


def htdemucs_recipe_epoch() -> None:
    """Phase 64: one epoch of ``python -m fqss_tpu_torch.train -env htdemucs`` (on the card, its default) with the
    full-width HTDEMUCS_CFG on a mini MUSDB that ``make_mini_musdb`` writes at HTD_SR; one batch EMA and one epoch
    EMA, Repitch on every example; the config as JSON."""
    with tempfile.TemporaryDirectory() as tmp:
        root = make_mini_musdb(os.path.join(tmp, "musdb"), n_train=2, n_test=1, sample_rate=HTD_SR,
                               seconds=HTD_RECIPE_SECONDS)
        conf = {
            "work_dir": os.path.join(tmp, "run"),
            "model_cfg": HTDEMUCS_CFG,
            "dataset_cfg": {"name": "musdbhq", "musdb_root": root, "metadata_file": os.path.join(tmp, "musdb.json"),
                            "sample_rate": HTD_SR, "segment": 1, "data_stride": 1,
                            "augmentation": {**HTD_AUGMENT, "repitch": {"proba": 1.0, "max_tempo": 12}}},
            "training_cfg": {"epochs": 1, "batch_size": 1, "kd_lambda": 0.1, "seed": 42,
                             "ema": {"batch": list(HTD_EMA), "epoch": [0.9]},
                             "optim": {"optimizer": "adam", "lr": 0.0003, "weight_decay": 0.0}},
            "testing_cfg": {"test_dir": root, "NSDR": True, "segment_samples": HTD_SEG, "overlap": 0.25},
        }
        path = os.path.join(tmp, "htdemucs.json")
        with open(path, "w") as fh:
            json.dump(conf, fh)
        env_vars = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "fqss_tpu_torch.train", "-env", "htdemucs", "-y", path],
                              cwd=tmp, env=env_vars, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        done = [line for line in proc.stdout.splitlines() if line.startswith("Training done")]
        if proc.returncode != 0 or not done:
            raise AssertionError(f"htdemucs recipe epoch failed ({proc.returncode}):\n{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        for out in ("best_model.pt", "latest_model.pt", "checkpoints/epoch_0.pt", "history.json"):
            if not os.path.exists(os.path.join(tmp, "run", out)):
                raise AssertionError(f"htdemucs recipe epoch wrote no {out}")
        with open(os.path.join(tmp, "run", "history.json")) as fh:
            history = json.load(fh)
        with open(os.path.join(tmp, "run", "results.txt")) as fh:
            lines = fh.read().splitlines()
        epoch_line = [line for line in lines if line.startswith("epoch 0:")]
        test_line = [line for line in lines if line.startswith("test epoch")]
        if not np.isfinite([history[0]["loss"], history[0]["valid_nsdr"]]).all() or not (epoch_line and test_line):
            raise AssertionError(f"htdemucs recipe epoch: history {history}, log {lines[-4:]}")
    bname = epoch_line[0].split("bname=")[1].split()[0]
    log(f"[64] python -m fqss_tpu_torch.train -env htdemucs with HTDEMUCS_CFG at full width: one epoch of 1 s windows "
        f"(Repitch on each, cut to {int(0.88 * HTD_SR)} samples) of a {HTD_RECIPE_SECONDS:g} s track, the main model, "
        f"one batch EMA and one epoch EMA validated on a track, the test track's NSDR, in {seconds:.1f} s (the process "
        f"included): train loss {history[0]['loss']:.4f}, valid NSDR {history[0]['valid_nsdr']:.3f} dB, best model "
        f"{bname}; {test_line[-1]}; {done[-1]}")


# The checkpoint-import slice (phases 65-69). A reference float checkpoint's key names, read backwards from the JAX
# package's maps (fqss_tpu/models/convert.py:*_params_from_torch): for each family, rules that rename a key of the
# port's float state dict into the reference's, applied in turn (re.sub), and the few tensors whose layout differs
# (the LSTM's weights, which the port keeps in JAX's [C, 4H]; the 1x1 Conv2d kernels the port holds as dense ones).
_NORM = (r"\.norm\.(weight|bias)$", r".\1")  # a LayerNorm/GroupNorm's scope: the reference's module is the norm itself
REFERENCE_KEYS = {
    "ConvTasNet": [
        (r"^masker\.tcn_(\d+)_(\d+)\.", lambda m, model: f"masker.TCN.{int(m[1]) * model.n_blocks + int(m[2])}."),
        (r"\.conv_in\.nl\.alpha$", ".shared_block.1.weight"), (r"\.conv_in\.", ".shared_block.0."),
        (r"\.norm_in\.norm\.", ".shared_block.2."),
        (r"\.conv_dw\.nl\.alpha$", ".shared_block.4.weight"), (r"\.conv_dw\.", ".shared_block.3."),
        (r"\.norm_dw\.norm\.", ".shared_block.5."),
        (r"^encoder\.conv\.", "encoder."), (r"^masker\.bottleneck_norm\.norm\.", "masker.bottleneck.0."),
        (r"^masker\.bottleneck_conv\.", "masker.bottleneck.1."),
        (r"^masker\.mask_prelu\.nl\.alpha$", "masker.mask_net.0.weight"),
        (r"^masker\.mask_conv\.", "masker.mask_net.1."),
    ],
    "DPTNet": [
        (r"^encoder\.conv\.", "encoder.conv1d_U."), (r"^enc_LN\.norm\.", "enc_LN."),
        (r"^separator\.DPT\.(row|col)_(\d+)\.", r"separator.DPT.\1_transformer.\2.transformer."),
        (r"\.self_attn\.out_proj_(weight|bias)$", r".self_attn.out_proj.\1"),
        (r"\.lstm\.fw\.w_(ih|hh)$", r".lstm.weight_\1_l0"), (r"\.lstm\.bw\.w_(ih|hh)$", r".lstm.weight_\1_l0_reverse"),
        (r"\.lstm\.fw\.b_(ih|hh)$", r".lstm.bias_\1_l0"), (r"\.lstm\.bw\.b_(ih|hh)$", r".lstm.bias_\1_l0_reverse"),
        _NORM,
        (r"^separator\.DPT\.out_prelu\.nl\.alpha$", "separator.DPT.output.0.weight"),
        (r"^separator\.DPT\.out_conv\.", "separator.DPT.output.1."),
        (r"^separator\.(output|output_gate)\.", r"separator.\1.0."), (r"^mask_conv1x1\.", "mask_conv1x1.0."),
        (r"^decoder\.", "decoder.basis_signals."),
    ],
    "Sepformer": [
        (r"^encoder\.conv\.", "encoder.0."), (r"^masker\.dp_(\d+)\.", r"masker.layers.\1."),
        (r"\.layer_(\d+)\.", r".layers.\1."), (r"\.mha\.out_proj_(weight|bias)$", r".mha.out_proj.\1"),
        (r"\.ffn_in\.", ".ffn.0."), (r"\.ffn_out\.", ".ffn.3."), _NORM,
        (r"^masker\.prelu\.nl\.alpha$", "masker.prelu.weight"),
        (r"^masker\.(net_out|net_gate|end_conv)\.", r"masker.\1.0."),
    ],
    "ConvTasNetMusic": [
        (r"^encoder\.conv\.", "encoder.0."), (r"^separator\.layer_norm\.", "separator.network.0."),
        (r"^separator\.bottleneck\.", "separator.network.1."), (r"^separator\.mask_conv\.", "separator.network.3."),
        (r"^separator\.tcn_(\d+)_(\d+)\.", r"separator.network.2.\1.\2."),
        (r"\.conv1x1\.nl\.alpha$", ".net.1.weight"), (r"\.conv1x1\.", ".net.0."),
        (r"\.dsconv\.depthwise\.nl\.alpha$", ".net.3.net.1.weight"), (r"\.dsconv\.depthwise\.", ".net.3.net.0."),
        (r"\.dsconv\.norm\.norm\.", ".net.3.net.2."), (r"\.dsconv\.pointwise\.", ".net.3.net.3."),
        (r"\.norm\.norm\.", ".net.2."),
    ],
    "HTDemucs": [
        (r"^(encoder|tencoder|decoder|tdecoder)_(\d+)\.", r"\1.\2."),
        (r"\.dconv\.layer_(\d+)_conv\.norm\.", r".dconv.layers.\1.1."),
        (r"\.dconv\.layer_(\d+)_conv\.", r".dconv.layers.\1.0."),
        (r"\.dconv\.layer_(\d+)_mix\.norm\.", r".dconv.layers.\1.4."),
        (r"\.dconv\.layer_(\d+)_mix\.", r".dconv.layers.\1.3."),
        (r"\.dconv\.layer_(\d+)_scale\.", r".dconv.layers.\1.6."),
        (r"^freq_emb\.embedding$", "freq_emb.embedding.weight"),
        (r"^crosstransformer\.layer_t_(\d+)\.", r"crosstransformer.layers_t.\1."),
        (r"^crosstransformer\.layer_(\d+)\.", r"crosstransformer.layers.\1."),
        (r"\.(self_attn|cross_attn)\.out_proj_(weight|bias)$", r".\1.out_proj.\2"), _NORM,
    ],
}
REFERENCE_LAYOUT = [  # (reference key, the tensor in the reference's layout)
    (r"\.lstm\.weight_(ih|hh)_l0(_reverse)?$", lambda v: v.T),
    (r"^(separator\.DPT\.output\.1|masker\.conv2d)\.weight$", lambda v: v[:, :, None, None]),
]


def reference_state_dict(name: str, model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The reference float checkpoint of a float model of family ``name`` (its float state dict under the
    reference's key names and layouts): what the JAX package's ``*_params_from_torch`` reads back into this model's
    weights (``tests/test_torch_checkpoint_import.py`` holds it to JAX)."""
    out = {}
    for key, v in model.state_dict().items():
        for pattern, repl in REFERENCE_KEYS[name]:
            key = re.sub(pattern, (lambda m, r=repl: r(m, model)) if callable(repl) else repl, key)
        for pattern, layout in REFERENCE_LAYOUT:
            if re.search(pattern, key):
                v = layout(v)
        out[key] = v.detach().cpu().contiguous().clone()
    return out


IMPORT_CFGS = {"ConvTasNet": MODEL_CFG, "DPTNet": DPTNET_CFG, "Sepformer": SEPFORMER_CFG, "ConvTasNetMusic": MUSIC_CFG,
               "HTDemucs": HTDEMUCS_CFG}
TO_JAX = {"ConvTasNet": convert.convtasnet_to_jax, "DPTNet": convert.dptnet_to_jax,
          "Sepformer": convert.sepformer_to_jax, "ConvTasNetMusic": convert.convtasnet_music_to_jax,
          "HTDemucs": convert.htdemucs_to_jax}


def write_reference_pth(path: str, name: str, source: torch.nn.Module) -> int:
    """``source``'s float weights as a reference checkpoint as a KD run saves one: wrapped in ``state_dict``, every
    key under ``model.``, with a stray ``fmodel.`` (teacher) key; returns the file's bytes."""
    ref = reference_state_dict(name, source)
    torch.save({"state_dict": {**{f"model.{k}": v for k, v in ref.items()}, "fmodel.encoder.weight": torch.zeros(3)}},
               path)
    return os.path.getsize(path)


def write_jax_npz(path: str, name: str, state: dict) -> int:
    """``state`` (a QAT model's weights, ranges and counters) as the JAX package's ``export_model`` writes its
    variables: a flat ``.npz`` keyed ``collection/scope/.../name`` in JAX's layouts; returns the file's bytes."""
    np.savez(path, **jax_export_entries(TO_JAX[name](state)))
    return os.path.getsize(path)


def import_input(name: str) -> torch.Tensor:
    """Phase 66's serving input of the family: one mixture of 1 s (HTDemucs: one OLA chunk, HTD_SEG)."""
    if name == "ConvTasNetMusic":
        return torch.from_numpy(music_mix(66, 1, MUSIC_SR))
    if name == "HTDemucs":
        return torch.from_numpy(htdemucs_mix(66, 1, HTD_SEG))
    return torch.from_numpy(synth_batch(np.random.default_rng(66), 1, 2, SR)[0])


def import_reference(dev, name: str, tmp: str) -> None:
    """Phase 65 for one family: a seeded float model at full width written as a reference ``.pth``, loaded through
    ``create_pretrained_model`` on the card; every float weight equal to the source's, the splitter-widened encoder
    holding it as its MSB plane."""
    cfg = IMPORT_CFGS[name]
    source = create_model(cfg, QuantSpec(), generator=torch.Generator().manual_seed(65))
    path = os.path.join(tmp, f"{name}.pth")
    size = write_reference_pth(path, name, source)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = create_pretrained_model({**cfg, "model_path": path}, observer=False, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    state, widened = model.state_dict(), []
    for k, v in source.state_dict().items():
        got = state[k].cpu()
        if got.shape != v.shape:
            widened.append(k)
            got = got[:, : v.shape[1]]
        if not torch.equal(got, v):
            raise AssertionError(f"{name}: the imported {k} differs from the reference checkpoint's")
    log(f"[65] {name}: a reference float checkpoint ({len(source.state_dict())} tensors under state_dict/model., one "
        f"fmodel. key, {size / 2**20:.1f} MiB) through create_pretrained_model on the card in {load_s:.3f} s (the "
        f"model's seeded init included): every float weight equal to the source model's, {', '.join(widened)} "
        f"widened to {model.q.n_splitter} splitter planes with the MSB plane the float kernel; the quantizer ranges "
        f"and the combiner's residual blocks at their init")


def import_jax_npz(dev, name: str, state: dict, tmp: str) -> tuple[str, dict]:
    """Phase 66 for one family: ``state`` (the QAT model an earlier phase served) written as a JAX ``.npz`` export,
    loaded through ``create_pretrained_model`` on the card; one serving forward bitwise equal to the source model's,
    with the same launches. Returns the file's path and the imported forward's launches."""
    cfg = IMPORT_CFGS[name]
    source = create_model(cfg, quant_spec_from_cfg(cfg, observer=False))
    source.load_state_dict(state)
    source = source.to(dev).eval()
    path = os.path.join(tmp, f"{name}.npz")
    size = write_jax_npz(path, name, state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = create_pretrained_model({**cfg, "model_path": path}, observer=False, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x = import_input(name).to(dev)
    kw = {"train": False} if name == "HTDemucs" else {}
    with torch.inference_mode():
        reset_all_launches()
        want_y = source(x, **kw)
        torch.cuda.synchronize()
        want = all_launches()
        reset_all_launches()
        y = model(x, **kw)
        torch.cuda.synchronize()
        got = all_launches()
    if not torch.equal(y, want_y) or got != want or not any(got.values()) or not torch.isfinite(y).all():
        raise AssertionError(f"{name}: the .npz import's forward: launches {got} (the source's {want}), max |diff| "
                             f"{(y - want_y).abs().max().item()}")
    with np.load(path) as f:
        arrays = len(f.files)
    log(f"[66] {name}: a JAX export (.npz, {arrays} arrays, {size / 2**20:.1f} MiB) of the weights "
        f"and ranges served above, through create_pretrained_model on the card in {load_s:.3f} s: a forward "
        f"{tuple(x.shape)} -> {tuple(y.shape)} bitwise equal to the source model's, launches "
        f"{', '.join(f'{k}={v}' for k, v in got.items() if v)} as the source's")
    return path, got


def kd_step_from_pretrained(dev, env: str, tmp: str) -> dict:
    """Phase 68 for one recipe: ``-env asteroid`` (the flagship ConvTasNet, TRAIN_CFG, 1 x TRAIN_SEG) or ``-env
    htdemucs`` (HTDEMUCS_CFG, the recipe's step and optimizer, 1 x HTD_TRAIN_SEG): a seeded float model at full
    width written as a reference ``.pth`` and given as ``training_cfg.pretrained`` is given,
    ``create_model_and_teacher(model_cfg, pretrained)``; the teacher equal to the source, one KD step at batch 1
    launching the module tree's kernels, a finite loss. Returns the step's launches."""
    name, cfg = ("ConvTasNet", TRAIN_CFG) if env == "asteroid" else (
        "HTDemucs", {**HTDEMUCS_CFG, "quantization": {**HTDEMUCS_CFG["quantization"],
                                                      "max_observations": MUSIC_TRAIN_WINDOW}})
    source = create_model(cfg, QuantSpec(), generator=torch.Generator().manual_seed(68))
    path = os.path.join(tmp, f"{name}_teacher.pth")
    write_reference_pth(path, name, source)
    t0 = time.perf_counter()
    model, teacher = create_model_and_teacher(cfg, path, generator=torch.Generator().manual_seed(0))
    load_s = time.perf_counter() - t0
    for k, v in source.state_dict().items():
        if not torch.equal(teacher.state_dict()[k], v):
            raise AssertionError(f"-env {env}: the teacher's {k} differs from the pretrained model's")
    model, teacher = model.to(dev), teacher.to(dev)
    if env == "asteroid":
        state = new_train_state(model, teacher)
        fwd, bwd = count_quantizers(model.modules()), backward_quantizers(model)
        want = no_launches(act=fwd["act"], weight=1, act_bwd=bwd["act"], weight_bwd=1,
                           qmatmul=fused_convs(teacher)["qmatmul"])
        mix, src = synth_batch(np.random.default_rng(68), 1, 2, TRAIN_SEG)
        seconds = TRAIN_SEG / SR

        def run() -> dict:
            return make_train_step(TrainConfig())(state, torch.from_numpy(mix).to(dev), torch.from_numpy(src).to(dev))
    else:
        tcfg = TrainConfig(lr=3e-4, grad_clip=0.0)
        state = TrainState(model, make_music_optimizer(tcfg, cfg, model), teacher)
        step = make_music_train_step(tcfg, HTD_AUGMENT, weight_kind="exp", is_htdemucs=True,
                                     source_weights=np.ones(len(HTDEMUCS_CFG["sources"]), np.float32),
                                     batch_ema_decays=HTD_EMA)
        emas = [_params_copy(model) for _ in HTD_EMA]
        want = htdemucs_train_launches(model, teacher)
        stems = torch.from_numpy(music_stems(68, 1, HTD_TRAIN_SEG)).to(dev)
        seconds = HTD_TRAIN_SEG / HTD_SR

        def run() -> dict:
            return step(state, stems, torch.Generator().manual_seed(68), emas)
    reset_all_launches()
    loss = float(run()["loss"])
    torch.cuda.synchronize()
    got = all_launches()
    if got != want or not math.isfinite(loss) or state.skipped:
        raise AssertionError(f"-env {env} step from pretrained: launches {got} != {want}, loss {loss}")
    log(f"[68] -env {env}: {name} at full width from a reference float checkpoint as training_cfg.pretrained "
        f"(create_model_and_teacher in {load_s:.2f} s, on the CPU): the teacher equal to the pretrained model; one KD "
        f"step of 1 x {seconds:g} s on the card, loss {loss:.4f}, finite, launches "
        f"{', '.join(f'{k}={v}' for k, v in got.items() if v)} (the module tree's)")
    del state, model, teacher
    torch.cuda.empty_cache()
    return got


def checkpoint_import(dev, states: dict) -> dict:
    """Phases 65-68, the checkpoint-import slice at full width: reference ``.pth`` files and JAX ``.npz`` exports of
    the five models through ``create_pretrained_model``, ``python -m fqss_tpu_torch.infer`` on the flagship's
    ``.npz``, and a KD step of ``-env asteroid`` and ``-env htdemucs`` from a reference ``pretrained:``. Returns the
    launches of the imported forwards and steps, summed."""
    total: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in IMPORT_CFGS:  # 65.
            import_reference(dev, name, tmp)
            torch.cuda.empty_cache()
        paths = {}
        for name in IMPORT_CFGS:  # 66.
            paths[name], got = import_jax_npz(dev, name, states[name], tmp)
            total = {k: total.get(k, 0) + v for k, v in got.items()}
            torch.cuda.empty_cache()
        def request(engine: str) -> None:  # 67., the two processes side by side
            sec = infer_cli_request("ConvTasNet", None, MODEL_CFG, engine, model_path=paths["ConvTasNet"])
            log(f"[67] python -m fqss_tpu_torch.infer --engine {engine} with model_cfg.model_path the flagship's .npz: "
                f"a 20 s mixture -> 2 sources of 20 s, finite, in {sec:.1f} s (the process included, beside the "
                f"other engine's)")

        side_by_side(lambda: request("folded"), lambda: request("int8"))
        for env in ("asteroid", "htdemucs"):  # 68.
            got = kd_step_from_pretrained(dev, env, tmp)
            total = {k: total.get(k, 0) + v for k, v in got.items()}
    return total


def quantizer_kinds(model) -> dict:
    """How many activation quantizers of each kind ``model`` holds: linear, mu-law, MSE."""
    kinds = {"linear": 0, "mulaw": 0, "mse": 0}
    for m in model.modules():
        if isinstance(m, MseActQuantizer):
            kinds["mse"] += 1
        elif isinstance(m, ActQuantizer):
            kinds[m.kind] += 1
    return kinds


def calibrate_timed(model) -> tuple[int, float]:
    """The host's MSE calibration of ``model``: (quantizers calibrated, seconds)."""
    t0 = time.perf_counter()
    n = calibrate_mse_quantizers(model)
    return n, time.perf_counter() - t0


def check_mulaw_quantizer(dev) -> dict:
    """Phase 69: the mu-law quantizer (``mu`` 3, ranges (-0.8, 0.7)) on the card, its inner grid on K1 and K1-bwd,
    against its plain version on the CPU at the flagship's splitter output (16 x 2 x 3 s): values within
    MULAW_REL_TOL of the range but at most DENSE_GRID_SHARE of them, which move one code; the input gradient likewise,
    the ranges' and mu's gradients (sums) within 1e-3 relative."""
    gen = torch.Generator().manual_seed(69)
    x = torch.randn(TRAIN_BATCH, 2, TRAIN_SEG, generator=gen) * 0.4
    g = torch.randn(x.shape, generator=gen)
    out = []
    for device in (dev, torch.device("cpu")):
        q = ActQuantizer(kind="mulaw", observer=False).to(device)
        with torch.no_grad():
            q.min_range.fill_(-0.8)
            q.max_range.fill_(0.7)
            q.mu.fill_(3.0)
        xd = x.to(device).requires_grad_()
        fq.reset_launches()
        y = q(xd)
        (y * g.to(device)).sum().backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
            if fq.LAUNCHES != {"act": 1, "weight": 0, "act_bwd": 1, "weight_bwd": 0}:
                raise AssertionError(f"the mu-law quantizer launched {fq.LAUNCHES}, not K1 and K1-bwd once each")
        out.append((y.detach().cpu(), xd.grad.cpu(), q.min_range.grad.cpu(), q.mu.grad.cpu()))
    (y_card, dx_card, dmn_card, dmu_card), (y_cpu, dx_cpu, dmn_cpu, dmu_cpu) = out
    far = (y_card - y_cpu).abs() > MULAW_REL_TOL * 0.8
    dx_far = (dx_card - dx_cpu).abs() > MULAW_REL_TOL * dx_cpu.abs().max()
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in ((dmn_card, dmn_cpu), (dmu_card, dmu_cpu))]
    if far.float().mean() > DENSE_GRID_SHARE or dx_far.float().mean() > DENSE_GRID_SHARE or max(rel) > 1e-3:
        raise AssertionError(f"mu-law quantizer card vs plain: {far.float().mean().item():.2e} of values and "
                             f"{dx_far.float().mean().item():.2e} of input gradients apart, range and mu gradients "
                             f"{rel} relative")
    err = (y_card - y_cpu).abs().max().item()
    log(f"[69] mu-law quantizer {tuple(x.shape)} on the card (K1 and K1-bwd inside) against its plain version on the "
        f"CPU: {far.float().mean().item():.2e} of values a code apart (<= {DENSE_GRID_SHARE}), max |diff| {err:.3e}; "
        f"input gradients {dx_far.float().mean().item():.2e} apart; range and mu gradients {rel[0]:.2e}, {rel[1]:.2e} "
        f"relative (<= 1e-3)")
    return {"max_abs_err": err}


def check_mse_observer(dev) -> None:
    """Phase 69: one MSE quantizer fed the same five activations on the card and on the CPU: each batch's bin counts
    over the new window, the window's ends and the counter bitwise, the re-binned histogram within MSE_HIST_L1 of the
    total count in L1."""
    gen = torch.Generator().manual_seed(69)
    q_card, q_cpu = MseActQuantizer(max_observations=5).to(dev).train(), MseActQuantizer(max_observations=5).train()
    worst = 0.0
    for k, (scale, shift) in enumerate(((1.0, 0.0), (0.5, 0.2), (2.0, -0.5), (1.5, 1.0), (0.2, 0.0))):
        x = torch.randn(MSE_OBSERVE_SHAPE, generator=gen) * scale + shift
        xd = x.to(dev)
        with torch.no_grad():
            q_card(xd)
            q_cpu(x)
            counts_card = histogram.bin_counts(xd, q_card.val_min, q_card.val_max).cpu()
            counts_cpu = histogram.bin_counts(x, q_cpu.val_min, q_cpu.val_max)
        for name in ("val_min", "val_max", "n_iter"):
            if not torch.equal(getattr(q_card, name).cpu(), getattr(q_cpu, name)):
                raise AssertionError(f"MSE observer {name} after {k + 1}: card {getattr(q_card, name).item()} vs CPU "
                                     f"{getattr(q_cpu, name).item()}")
        if not torch.equal(counts_card, counts_cpu):
            raise AssertionError(f"MSE observer bin counts of batch {k}: {(counts_card != counts_cpu).sum()} bins apart")
        l1 = float((q_card.hist.cpu() - q_cpu.hist).abs().sum() / q_cpu.hist.sum())
        if l1 > MSE_HIST_L1:
            raise AssertionError(f"MSE observer histogram after {k + 1}: L1 {l1:.3e} of the count > {MSE_HIST_L1}")
        worst = max(worst, l1)
    log(f"[69] MSE observer, five activations of {tuple(MSE_OBSERVE_SHAPE)} on the card and on the CPU: bin counts, "
        f"window [{q_cpu.val_min.item():.4f}, {q_cpu.val_max.item():.4f}] and counter bitwise equal; re-binned "
        f"histogram L1 at most {worst:.3e} of the count (<= {MSE_HIST_L1})")


def variant_training(dev) -> tuple[TrainState, dict]:
    """Phase 69: the flagship with VARIANT_CFG's quantizers trained through its window and calibrated
    (``variant_state``); the mu-law and MSE checks; the calibrated step card vs CPU. Returns the calibrated state and
    the launches of the steps."""
    state, run = variant_state(dev)
    mulaw = check_mulaw_quantizer(dev)
    check_mse_observer(dev)
    variant_card_vs_cpu(dev, state)
    return state, {**run, "mulaw": mulaw}


def variant_card_vs_cpu(dev, state: TrainState) -> None:
    """Phase 69: one step of 1 x 1 s from the calibrated state on the card, on the CPU, and on the CPU on one thread
    (its own sums split otherwise: the CPU's own floor). Phase 10's rule, fixed before the first run: the loss within
    LOSS_DB_TOL raises where it fails; the whole-gradient cosine >= GRAD_COS_MIN failed at this configuration in the
    first runs (0.99868 and 0.99886), where the CPU against itself on one thread read 0.99900
    (``scripts/variant_step_floor.py``), so its verdict is printed beside that floor and does not raise (ROADMAP.md,
    queue 3)."""
    mix, src = synth_batch(np.random.default_rng(10), 1, 2, SR)
    runs = []
    threads = torch.get_num_threads()
    for device, n in ((dev, threads), (torch.device("cpu"), threads), (torch.device("cpu"), 1)):
        torch.set_num_threads(n)
        st = new_train_state(copy.deepcopy(state.model).to(device), copy.deepcopy(state.teacher).to(device))
        metrics = make_train_step(TrainConfig())(st, torch.from_numpy(mix).to(device), torch.from_numpy(src).to(device))
        runs.append((float(metrics["loss"]),
                     torch.cat([p.grad.flatten().double().cpu() for p in st.model.parameters() if p.grad is not None])))
    torch.set_num_threads(threads)
    (loss_card, g_card), (loss_cpu, g_cpu), (loss_one, g_one) = runs
    cos = lambda a, b: float(a @ b / (a.norm() * b.norm()))
    diff, card_cos, own_cos = abs(loss_card - loss_cpu), cos(g_card, g_cpu), cos(g_cpu, g_one)
    if diff > LOSS_DB_TOL:
        raise AssertionError(f"calibrated step card vs CPU: loss {loss_card} vs {loss_cpu} dB (tolerance "
                             f"{LOSS_DB_TOL})")
    log(f"[69] calibrated step card vs CPU at 1 x {SR}: loss {loss_card:.5f} vs {loss_cpu:.5f} dB (|diff| {diff:.2e} "
        f"<= {LOSS_DB_TOL}); whole-gradient cosine {card_cos:.6f}: phase 10's rule (>= {GRAD_COS_MIN}) "
        f"{'holds' if card_cos >= GRAD_COS_MIN else 'FAILS'}; the CPU against itself on one thread: loss "
        f"{loss_one:.5f} dB, cosine {own_cos:.6f} (1 - cos card vs CPU {1 - card_cos:.3e}, the CPU's own "
        f"{1 - own_cos:.3e}, {(1 - card_cos) / max(1 - own_cos, 1e-30):.2f}x) over {g_card.numel()} values")
    if card_cos < GRAD_COS_MIN:
        standing(f"phase 69's calibrated step card vs CPU: whole-gradient cosine {card_cos:.6f} (rule >= "
                 f"{GRAD_COS_MIN}); the CPU against itself on one thread {own_cos:.6f}")


def variant_state(dev, cfg: dict = VARIANT_CFG) -> tuple[TrainState, dict]:
    """Phase 69's steps: the flagship with ``cfg``'s quantizers, KD steps of 16 x 3 s through the window, the host's
    calibration, then more steps, each with the module tree's launches. Returns the state and the run's launches,
    calibration seconds and count."""
    model, teacher = create_model_and_teacher(cfg, generator=torch.Generator().manual_seed(69))
    kinds = quantizer_kinds(model)
    state = new_train_state(model.to(dev), teacher.to(dev))
    step = make_train_step(TrainConfig())
    fwd, bwd = count_quantizers(model.modules()), backward_quantizers(model)
    want = {"act": fwd["act"], "weight": 1, "act_bwd": bwd["act"], "weight_bwd": 1}
    rng = np.random.default_rng(69)
    inside, after = VARIANT_STEPS
    losses, n_cal, cal_s = [], 0, 0.0
    fq.reset_launches()
    t0 = time.perf_counter()
    for i in range(inside + after):
        if i == inside and kinds["mse"]:  # the recipe's calibration, after the step at which the window closes
            if not has_pending_mse(state.model):
                raise AssertionError("no MSE quantizer is pending at the window's close")
            n_cal, cal_s = calibrate_timed(state.model)
            if n_cal != kinds["mse"] or has_pending_mse(state.model):
                raise AssertionError(f"calibrated {n_cal} of {kinds['mse']} MSE quantizers")
        mix, src = synth_batch(rng, TRAIN_BATCH, 2, TRAIN_SEG)
        before = dict(fq.LAUNCHES)
        metrics = step(state, torch.from_numpy(mix).to(dev), torch.from_numpy(src).to(dev))
        got = {k: fq.LAUNCHES[k] - before[k] for k in fq.LAUNCHES}
        if got != want:
            raise AssertionError(f"variant train step {i}: launches {got} != {want}")
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(fq.LAUNCHES)
    if not np.isfinite(losses).all() or state.skipped:
        raise AssertionError(f"variant losses {losses}, skipped {state.skipped}")
    log(f"[69] flagship with {', '.join(f'{k} {v}' for k, v in cfg['quantization'].items() if k in VARIANT_KEYS)} "
        f"({kinds['mse']} MSE, {kinds['mulaw']} mu-law, {kinds['linear']} linear act quantizers), KD steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEG // SR} s: {inside} in the window, the MSE calibration of {n_cal} quantizers in "
        f"{cal_s:.2f} s (host), {after} after it; {seconds:.1f} s in all; losses {[round(v, 3) for v in losses]} dB, "
        f"finite, skipped 0; every step launched act={want['act']} (= act quantizer modules, the mu-law sites' inner "
        f"grids among them) act_bwd={want['act_bwd']} (= those reaching the loss) and the {fwd['weight']} weight "
        f"quantizers in weight=1 and weight_bwd=1")
    return state, {"launches": launches, "calibration_s": cal_s, "calibrated": n_cal}


def serve_variants(dev, smi: str, state: dict) -> dict:
    """Phase 70: the calibrated flagship of phase 69 (``state``) served at 32 x 12 s. Returns the forward's
    launches."""
    served = create_pretrained_model(VARIANT_CFG, observer=False, device=dev)
    served.load_state_dict(state)
    counts = count_quantizers(served.modules())
    mix, _ = synth_batch(np.random.default_rng(70), BATCH, 2, SEG)
    x = torch.from_numpy(mix).to(dev)
    reset_all_launches()
    with torch.inference_mode():
        y = served(x)
    torch.cuda.synchronize()
    launches = all_launches()
    if launches != no_launches(act=counts["act"], weight=1):
        raise AssertionError(f"variant forward launches {launches} != {counts['act']} act and one grouped weight")
    if tuple(y.shape) != (BATCH, 2, SEG) or not torch.isfinite(y).all():
        raise AssertionError(f"variant forward gave shape {tuple(y.shape)}, finite={bool(torch.isfinite(y).all())}")
    folded = fold_quantized_weights(served)
    reset_all_launches()
    with torch.inference_mode():
        y_folded = folded(x)
    torch.cuda.synchronize()
    if all_launches() != no_launches(act=counts["act"]):
        raise AssertionError(f"the folded variant launched {all_launches()}")
    if not torch.equal(y_folded, y):
        raise AssertionError(f"folded variant != fake-quant, max abs diff {(y_folded - y).abs().max().item()}")
    log(f"[70] calibrated flagship {tuple(x.shape)} -> {tuple(y.shape)}, finite; launches act={launches['act']} (= act "
        f"quantizer modules) weight=1 (its {counts['weight']} weight quantizers); folded bitwise equal, act "
        f"{counts['act']}, weight 0")
    # card vs CPU on one repeat of the TCN (the first), and at full depth for the record
    x1 = torch.from_numpy(mix[:1, :SR])
    snrs = {}
    for depth, cfg in (("one repeat", {**VARIANT_CFG, "n_repeats": 1}), ("full depth", VARIANT_CFG)):
        card = create_model(cfg, served.q)
        card.load_state_dict({k: state[k] for k in card.state_dict()})
        cpu = copy.deepcopy(card).eval()
        card = card.to(dev).eval()
        with torch.inference_mode():
            snrs[depth] = snr_db(cpu(x1), card(x1.to(dev)).cpu())
    if not bool((snrs["one repeat"] >= 20).all()):
        raise AssertionError(f"variant card vs CPU at one repeat: SNR {snrs['one repeat'].tolist()} dB < 20 dB")
    log(f"[70] card vs CPU at 1 x {SR}: one repeat SNR {[round(v, 2) for v in snrs['one repeat'].flatten().tolist()]} "
        f"dB (>= 20); full depth {[round(v, 2) for v in snrs['full depth'].flatten().tolist()]} dB (not checked)")
    try:
        make_int8_engine(served)
    except NotImplementedError as e:
        refusal = str(e)
    else:
        raise AssertionError("the int8 engine served a mu-law output grid")
    auto = auto_serving_model(served)
    if auto is served or auto.q.weight_quant:
        raise AssertionError("auto did not serve the folded model")
    audio_s = BATCH * SEG / SR
    for name, model in (("fake_quant", served), ("folded", folded)):
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(x), 3)
        log(f"[70] throughput {name}: {audio_s / (ms / 1000):.1f} sec-audio/s ({ms:.1f} ms per forward of {BATCH} x "
            f"{SEG // SR} s) on {smi}")
    del folded, y_folded, y, x
    torch.cuda.empty_cache()
    log(f"[70] int8 engine refused ({refusal}); auto serves the folded model")
    grids = export_quantizer_grids(served)

    def kinds(node):
        if "kind" in node:
            yield node["kind"]
        else:
            for v in node.values():
                yield from kinds(v)

    by_kind = {k: list(kinds(grids)).count(k) for k in ("per_tensor", "per_channel", "mulaw")}
    if by_kind["mulaw"] != 2 or by_kind["per_channel"] != counts["weight"]:
        raise AssertionError(f"deploy grids {by_kind}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "variant.npz")
        size = write_jax_npz(path, "ConvTasNet", state)
        sec = infer_cli_request("variant", None, VARIANT_CFG, "auto", model_path=path)
    log(f"[70] deploy grids of export_quantizer_grids: {by_kind}; python -m fqss_tpu_torch.infer --engine auto on the "
        f"state as a JAX .npz ({size / 1e6:.1f} MB): 20 s mixture -> 2 sources in {sec:.1f} s (the process included)")
    return launches


def res_dec_dptnet(dev, smi: str) -> dict:
    """Phase 71: DPTNet with RES_DEC_CFG's trained residual decoder and MSE quantizer: its grouped weight kernels,
    KD steps through the window and the calibration, then serving at 8 x 4 s. Returns the launches of the steps and
    of the serving forward."""
    model, teacher = create_model_and_teacher(RES_DEC_CFG, generator=torch.Generator().manual_seed(71))
    n_weight = count_quantizers(model.modules())["weight"]
    if n_weight != RES_DEC_WEIGHT_QUANTIZERS or len(weight_quantizer_sites(model)) != n_weight:
        raise AssertionError(f"DPTNet with train_res_dec holds {n_weight} weight quantizers, "
                             f"{len(weight_quantizer_sites(model))} in its pass")
    name = "DPTNet (train_res_dec)"
    groups, pairs = check_weight_groups(dev, {name: copy.deepcopy(model).to(dev).train()}, phase=71)
    group_bwd = check_weight_group_bwd(dev, pairs, phase=71)
    del pairs
    torch.cuda.empty_cache()
    kinds = quantizer_kinds(model)
    state = new_train_state(model.to(dev), teacher.to(dev))
    step = make_train_step(TrainConfig())
    want = train_launches(model, teacher)
    rng = np.random.default_rng(71)
    inside, after = RES_DEC_STEPS
    losses, n_cal, cal_s = [], 0, 0.0
    reset_all_launches()
    t0 = time.perf_counter()
    for i in range(inside + after):
        if i == inside:
            n_cal, cal_s = calibrate_timed(state.model)
            if n_cal != kinds["mse"] or has_pending_mse(state.model):
                raise AssertionError(f"calibrated {n_cal} of {kinds['mse']} MSE quantizers")
        mix, src = synth_batch(rng, 1, 2, DPT_TRAIN_SEG)
        before = all_launches()
        metrics = step(state, torch.from_numpy(mix).to(dev), torch.from_numpy(src).to(dev))
        got = {k: v - before[k] for k, v in all_launches().items()}
        if got != want:
            raise AssertionError(f"{name} train step {i}: launches {got} != {want}")
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    train_run = all_launches()
    if not np.isfinite(losses).all() or state.skipped:
        raise AssertionError(f"{name} losses {losses}, skipped {state.skipped}")
    log(f"[71] {name} with act_quantizer mse ({kinds['mse']} MSE act quantizers, {n_weight} weight quantizers), KD "
        f"steps of 1 x {DPT_TRAIN_SEG // SR} s: {inside} in the window, the calibration of {n_cal} quantizers in "
        f"{cal_s:.2f} s (host), {after} after it; {seconds:.1f} s in all; losses {[round(v, 3) for v in losses]} dB, "
        f"finite, skipped 0; every step launched {', '.join(f'{k}={v}' for k, v in want.items() if v)} (student and "
        f"teacher; K5/K5-bwd with the MSE flag, K8's head grid by the composition), all others 0")
    calibrated = state_on_cpu(state.model)
    del state, model, teacher
    torch.cuda.empty_cache()

    # serving at 8 x 4 s
    dpt = create_pretrained_model(RES_DEC_CFG, observer=False, device=dev)
    dpt.load_state_dict(calibrated)
    counts, dense, fused = count_quantizers(dpt.modules()), dense_quantizers(dpt), fused_convs(dpt)
    n_mha = sum(isinstance(m, QMultiheadAttention) for m in dpt.modules())
    dmix, _ = synth_batch(np.random.default_rng(71), DPT_BATCH, 2, DPT_SEG)
    x = torch.from_numpy(dmix).to(dev)
    reset_all_launches()
    with torch.inference_mode():
        y = dpt(x)
    torch.cuda.synchronize()
    serve_run = all_launches()
    serve_want = no_launches(act=counts["act"] - 3 * n_mha - dense["act"] - fused["act"], weight=1,
                             bilstm=2 * dpt.layer, attention=n_mha, dense=dense["dense"], qmatmul=fused["qmatmul"])
    if serve_run != serve_want:
        raise AssertionError(f"{name} serving launches {serve_run} != {serve_want}")
    if tuple(y.shape) != (DPT_BATCH, 2, DPT_SEG) or not torch.isfinite(y).all():
        raise AssertionError(f"{name} forward gave shape {tuple(y.shape)}, finite={bool(torch.isfinite(y).all())}")
    folded = fold_quantized_weights(dpt)
    with torch.inference_mode():
        y_folded = folded(x)
    if not torch.equal(y_folded, y):
        raise AssertionError(f"folded {name} != fake-quant, max abs diff {(y_folded - y).abs().max().item()}")
    log(f"[71] {name} served {tuple(x.shape)} -> {tuple(y.shape)}, finite; launches "
        f"{', '.join(f'{k}={v}' for k, v in serve_run.items() if v)} (phase 18's rule); folded bitwise equal")
    cpu_dpt = create_pretrained_model(RES_DEC_CFG, observer=False)
    cpu_dpt.load_state_dict(calibrated)
    x1 = torch.from_numpy(dmix[:1, :SR])
    with torch.inference_mode():
        y_card, y_cpu = dpt(x1.to(dev)).cpu(), cpu_dpt(x1)
    snr = snr_db(y_cpu, y_card)
    if not bool((snr >= 20).all()):
        raise AssertionError(f"{name} card vs CPU SNR {snr.tolist()} dB < 20 dB")
    floor = (snr.min().item(), (y_card - y_cpu).abs().mean().item() / out_step(dpt))
    log(f"[71] {name} card vs CPU at 1 x {SR}: SNR {[round(v, 2) for v in snr.flatten().tolist()]} dB (>= 20), mean "
        f"{floor[1]:.4f} output steps")
    layers = 2 * dpt.layer
    int8_run = no_launches(act=layers, bilstm=layers, int8_mm=dptnet_int8_sites(dpt))  # its forward launches these
    engines = int8_engines_vs_fake_quant(71, name, dpt, cpu_dpt, x, y, floor, int8_run, DPT_INT8_CARD_VS_CPU_DB,
                                         dtypes=("float32",))
    if auto_serving_model(dpt) is not dpt:
        raise AssertionError(f"auto did not serve {name}'s fake-quant model, the table's DPTNet path")
    audio_s = DPT_BATCH * DPT_SEG / SR
    for label, fn in (("fake_quant", dpt), ("folded", folded), ("int8 float32", engines["float32"])):
        with torch.inference_mode():
            ms = cuda_ms(lambda: fn(x), 3)
        log(f"[71] {name} throughput {label}: {audio_s / (ms / 1000):.1f} sec-audio/s ({ms:.1f} ms per forward of "
            f"{DPT_BATCH} x {DPT_SEG // SR} s) on {smi}")
    log(f"[71] {name}: auto serves the fake-quant model (the table's DPTNet path)")
    del engines, folded, dpt, y, y_folded, x
    torch.cuda.empty_cache()
    return {"train": train_run, "serve": serve_run, "int8": int8_run, "groups": groups[name],
            "group_bwd": group_bwd[name]}


def quant_variants(dev, smi: str) -> dict:
    """Phases 69-71. Returns each kernel counter's launches over the three phases' runs that it checks (phase 69's
    steps, phase 70's forward, phase 71's steps, serving forward and int8 forward; each kernel of the slice's path
    launched at least once) and phase 71's grouped weight results."""
    state, trained = variant_training(dev)  # 69.
    calibrated = state_on_cpu(state.model)
    del state
    torch.cuda.empty_cache()
    clock("69")
    served = serve_variants(dev, smi, calibrated)  # 70.
    clock("70")
    res_dec = res_dec_dptnet(dev, smi)  # 71.
    clock("71")
    runs = (trained["launches"], served, res_dec["train"], res_dec["serve"], res_dec["int8"])
    launches = {k: sum(run.get(k, 0) for run in runs) for k in all_launches()}
    path = ("act", "weight", "act_bwd", "weight_bwd", "int8_mm", "bilstm", "attention", "dense", "dense_mask",
            "dense_dx", "dense_dwq", "qmatmul")
    if not all(launches[k] for k in path):
        raise AssertionError(f"phases 69-71 launched no {[k for k in path if not launches[k]]}")
    return {"launches": launches, "res_dec": res_dec, "calibration_s": trained["calibration_s"],
            "mulaw": trained["mulaw"]}


def static_bound(dirs: int, T: int, B: int, H: int) -> tuple[int, int]:
    """Bytes and operations of a static-route launch: the fused launch's (lstm_bound), the 12 grids' ranges in, and
    the sites' quantizations."""
    moved, ops = lstm_bound(dirs, T, B, H)
    return moved + 4 * dirs * 2 * len(lk.SITES), ops + dirs * T * B * H * STATIC_SITE_OPS


def fitted_sites(ih: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Site ranges that the observer window fits to this input: the plain version's EMA from -0.5/0.5 over its first
    min(T, 50) steps."""
    k = min(ih.shape[0], lk.OBSERVE_STEPS)
    start = torch.full((len(lk.SITES),), 0.5, device=ih.device)
    with torch.no_grad():
        _, mn, mx = lk.lstm_static_sequence_ref(ih[:k], w, -start, start, k)
    return mn.contiguous(), mx.contiguous()


def static_rule(name: str, got: torch.Tensor, want: torch.Tensor, ranges, want_ranges) -> tuple[float, float, float]:
    """Phase 72's rule on one direction's output and ranges: (max |difference| in output steps, share more than half
    a step apart, the ranges' largest difference against their width); raises where it fails."""
    mn, mx = want_ranges
    step = float(mx[11] - mn[11]) / 255
    diff = (got - want).abs()
    steps, share = diff.max().item() / step, (diff > 0.5 * step).float().mean().item()
    rel = max(((a - b).abs() / (mx - mn)).max().item() for a, b in zip(ranges, want_ranges))
    if steps > 1 + 1e-4 or share > STATIC_SHARE or rel > STATIC_RANGE_REL:
        raise AssertionError(f"static route {name}: max |kernel - plain| {steps:.3f} output steps (at most 1), "
                             f"{share:.4f} of values half a step apart (at most {STATIC_SHARE}), ranges {rel:.3g} of "
                             f"their width apart (at most {STATIC_RANGE_REL})")
    return steps, share, rel


def check_static_route(dev, shapes: list[tuple[str, int, int, int]], per_forward: int,
                       stream_shapes: list[tuple[str, int, int, int]]) -> tuple[dict, dict]:
    """Phase 72: the static route (K7 both directions, K6 one) against the plain static recurrence, with the window
    closed and closing after STATIC_WINDOW steps; times per DPTNet forward (``per_forward`` launches at each of
    ``shapes``) and, for K6, per launch at the row shape. Returns (K6 results, K7 results)."""
    gen = torch.Generator(device=dev).manual_seed(72)
    k6 = {"max_abs_err": 0.0}
    k7 = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "fused_ms": 0.0, "window_ms": 0.0, "max_steps": 0.0,
          "share": 0.0, "range_rel": 0.0}
    moved = ops = 0
    for side, T, B, H in [*shapes, *stream_shapes, ("odd", *LSTM_ODD)]:
        ih = [torch.randn(T, B, 4 * H, device=dev, generator=gen) * 0.5 for _ in range(2)]
        w = [(torch.rand(H, 4 * H, device=dev, generator=gen) * 2 - 1) / math.sqrt(H) for _ in range(2)]
        sites = [fitted_sites(ih[d], w[d]) for d in range(2)]
        cases = []
        for observe in (0, min(STATIC_WINDOW, T)):
            before = dict(lk.LAUNCHES)
            with torch.no_grad():
                hf, hb, rf, rb = lk.bilstm_static_sequence(ih[0], ih[1], w[0], w[1], sites[0], sites[1], observe)
                h1, *r1 = lk.lstm_static_sequence(ih[1], w[1], *sites[1], observe)
                want = [lk.lstm_static_sequence_ref(ih[d], w[d], *sites[d], observe) for d in range(2)]
            torch.cuda.synchronize()
            n = 2 if 0 < observe < T else 1
            expect = {**before, "lstm_static": before["lstm_static"] + n, "bilstm_static": before["bilstm_static"] + n}
            if lk.LAUNCHES != expect:
                raise AssertionError(f"static route {side}, window {observe}: launches {lk.LAUNCHES} != {expect}")
            rules = [static_rule(f"{side} T {T} x B' {B} x H {H}, window {observe}", got, hs, ranges, (mn, mx))
                     for got, ranges, (hs, mn, mx) in ((hf, rf, want[0]), (hb, rb, want[1]), (h1, r1, want[1]))]
            err7 = max((hf - want[0][0]).abs().max().item(), (hb - want[1][0]).abs().max().item())
            err6 = (h1 - want[1][0]).abs().max().item()
            k6["max_abs_err"], k7["max_abs_err"] = max(k6["max_abs_err"], err6), max(k7["max_abs_err"], err7)
            for i, key in enumerate(("max_steps", "share", "range_rel")):
                k7[key] = max(k7[key], *(r[i] for r in rules))
            cases.append(f"window {observe}: {n} launch(es), max {max(r[0] for r in rules):.3f} output steps, "
                         f"{max(r[1] for r in rules):.4f} half a step apart, ranges {max(r[2] for r in rules):.2g} "
                         f"of their width")
            del hf, hb, h1, want
        line = (f"[72] static route {side} T {T} x B' {B} x H {H}: K7 plan "
                f"{lk.launch_plan(dev, B, H, 2, lk.MODES['static'])}, window launch "
                f"{lk.launch_plan(dev, B, H, 2, lk.MODES['observe'])}; {'; '.join(cases)} (rule: <= 1 step, <= "
                f"{STATIC_SHARE}, <= {STATIC_RANGE_REL})")
        if side == "odd":
            log(line)
            continue
        b7, b6 = bound_of(*static_bound(2, T, B, H), F32_OPS_S), bound_of(*static_bound(1, T, B, H), F32_OPS_S)
        with torch.no_grad():
            ms7 = cuda_ms(lambda: lk.bilstm_static_sequence(ih[0], ih[1], w[0], w[1], sites[0], sites[1]), 10)
            ms6 = cuda_ms(lambda: lk.lstm_static_sequence(ih[0], w[0], *sites[0]), 10)
            fused = cuda_ms(lambda: lk.bilstm_sequence(ih[0], ih[1], w[0], w[1]), 10)
            window = cuda_ms(lambda: lk.bilstm_static_sequence(ih[0], ih[1], w[0], w[1], sites[0], sites[1],
                                                                STATIC_WINDOW), 3)
        if side.startswith("stream"):
            log(f"{line}; K7 static {ms7:.4f} ms ({b7['bound_ms'] / ms7:.1%} of its {b7['bound_ms']:.4f} ms bound by "
                f"{b7['bound_by']}), fused {fused:.4f} ms, a call inside the window {window:.4f} ms, K6 static "
                f"{ms6:.4f} ms ({b6['bound_ms'] / ms6:.1%})")
            continue
        with torch.no_grad():
            plain, lo, hi = median_ms(lambda: [lk.lstm_static_sequence_ref(ih[d], w[d], *sites[d], 0)
                                               for d in range(2)], STATIC_PLAIN_REPS)
            plain6 = median_ms(lambda: lk.lstm_static_sequence_ref(ih[0], w[0], *sites[0], 0), STATIC_PLAIN_REPS)[0]
        log(f"{line}; K7 static {ms7:.3f} ms ({b7['bound_ms'] / ms7:.1%} of its {b7['bound_ms']:.3f} ms bound by "
            f"{b7['bound_by']}), fused on the same input {fused:.3f} ms, a call inside the window {window:.3f} ms (two "
            f"launches and the EMA), K6 static {ms6:.3f} ms ({b6['bound_ms'] / ms6:.1%} of {b6['bound_ms']:.3f}); "
            f"plain static {plain:.1f} ms (median of {STATIC_PLAIN_REPS}, {lo:.1f}-{hi:.1f}), one direction "
            f"{plain6:.1f} ms")
        k7["ms"] += per_forward * ms7
        k7["plain_ms"] += per_forward * plain
        k7["fused_ms"] += per_forward * fused
        k7["window_ms"] += per_forward * window
        b_moved, b_ops = static_bound(2, T, B, H)
        moved, ops = moved + per_forward * b_moved, ops + per_forward * b_ops
        if side == "row":
            k6.update(ms=ms6, plain_ms=plain6, library_ms=None, **b6)
        del ih, w
        torch.cuda.empty_cache()
    k7.update(bound_of(moved, ops, F32_OPS_S), library_ms=None)
    log(f"[72] one static DPTNet forward's {2 * per_forward} static-route launches: {k7['ms']:.2f} ms against a "
        f"{k7['bound_ms']:.2f} ms bound by {k7['bound_by']} ({k7['bound_ms'] / k7['ms']:.1%}); K7's fused route on "
        f"the same inputs {k7['fused_ms']:.2f} ms; every call inside the window {k7['window_ms']:.2f} ms; plain "
        f"static {k7['plain_ms']:.1f} ms; no library call computes the quantized cell (library_ms null)")
    return k6, k7


def static_train(dev) -> dict:
    """Phase 73's KD steps: a fresh static-mode DPTNet (STATIC_TRAIN_LAYERS dual-path layers) and its float teacher,
    STATIC_TRAIN_STEPS steps of 1 x DPT_TRAIN_SEG; returns the run's launches."""
    cfg = train_cfg({**STATIC_CFG, "layer": STATIC_TRAIN_LAYERS})
    model, teacher = create_model_and_teacher(cfg, generator=torch.Generator().manual_seed(73))
    lstms = [m for m in model.modules() if isinstance(m, QLSTM)]
    if {m.mode for m in lstms} != {"static"}:
        raise AssertionError(f"static-mode DPTNet's LSTMs take the modes {[m.mode for m in lstms]}")
    calls = dpt_lstm_shapes(1, DPT_TRAIN_SEG, model)
    if min(T for _, T, _, _ in calls) <= lk.OBSERVE_STEPS:
        raise AssertionError(f"phase 73's LSTM calls {calls} do not cross the window in one step")
    base = train_launches(model, teacher)
    closed = {**base, "bilstm": base["bilstm"] - len(lstms), "bilstm_static": len(lstms)}
    state = new_train_state(model.to(dev), teacher.to(dev))
    step = make_train_step(TrainConfig())
    rng = np.random.default_rng(73)
    losses = []
    reset_all_launches()
    t0 = time.perf_counter()
    for i in range(STATIC_TRAIN_STEPS):
        mix, src = synth_batch(rng, 1, 2, DPT_TRAIN_SEG)
        want = {**closed, "bilstm_static": 2 * len(lstms)} if i == 0 else closed  # a window launch a call
        before = all_launches()
        metrics = step(state, torch.from_numpy(mix).to(dev), torch.from_numpy(src).to(dev))
        got = {k: v - before[k] for k, v in all_launches().items()}
        if got != want:
            raise AssertionError(f"static DPTNet train step {i}: launches {got} != {want}")
        losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = sorted({int(v) for k, v in state.model.state_dict().items() if k.endswith("site_n_iter")})
    if not np.isfinite(losses).all() or state.skipped or counts != [lk.OBSERVE_STEPS]:
        raise AssertionError(f"static DPTNet losses {losses}, skipped {state.skipped}, site counts {counts}")
    log(f"[73] DPTNet lstm_mode static, its first {STATIC_TRAIN_LAYERS} dual-path layer(s), {STATIC_TRAIN_STEPS} KD "
        f"step(s) of 1 x {DPT_TRAIN_SEG // SR} s (LSTMs {', '.join(f'{s} T {T} x B {B}' for s, T, B, _ in calls)}) in "
        f"{seconds:.1f} s: losses {[round(v, 3) for v in losses]} dB, finite, skipped 0, every site_n_iter "
        f"{lk.OBSERVE_STEPS}; the first step launched bilstm_static={2 * len(lstms)} ({len(lstms)} calls inside the "
        f"window, two launches each), the second {len(lstms)}; every step "
        f"{', '.join(f'{k}={v}' for k, v in closed.items() if v and k != 'bilstm_static')} (student and teacher: the "
        f"teacher's LSTMs on K7), all others 0")
    launches = all_launches()
    del state, model, teacher
    torch.cuda.empty_cache()
    return launches


def serve_static(dev, smi: str, dpt_state: dict) -> dict:
    """Phase 73's serving: phase 18's weights and ranges in a static-mode DPTNet, its sites' window observed in one
    train-mode forward, then fake_quant, folded, int8 and card vs CPU at 8 x 4 s. Returns the forward's launches, the
    int8 forward's and the served state."""
    observer = create_pretrained_model(STATIC_CFG, observer=True, device=dev)
    missing = observer.load_state_dict({k: v.to(dev) for k, v in dpt_state.items()}, strict=False).missing_keys
    if not missing or any("site_" not in k for k in missing):
        raise AssertionError(f"phase 18's state in the static-mode DPTNet: missing {missing}")
    dmix, _ = synth_batch(np.random.default_rng(73), DPT_BATCH, 2, DPT_SEG)
    x = torch.from_numpy(dmix).to(dev)
    reset_all_launches()
    with torch.no_grad():
        observer.train()(x[:2])
    n_lstm = sum(isinstance(m, QLSTM) for m in observer.modules())
    window = all_launches()
    if window["bilstm_static"] != 2 * n_lstm or window["bilstm"] or window["lstm_static"]:
        raise AssertionError(f"the static DPTNet's window forward launched {window}")
    dpt = create_pretrained_model(STATIC_CFG, observer=False, device=dev)
    dpt.load_state_dict(observer.state_dict())
    del observer
    counts, dense, fused = count_quantizers(dpt.modules()), dense_quantizers(dpt), fused_convs(dpt)
    n_mha = sum(isinstance(m, QMultiheadAttention) for m in dpt.modules())
    want = no_launches(act=counts["act"] - 3 * n_mha - dense["act"] - fused["act"], weight=1, bilstm_static=n_lstm,
                       attention=n_mha, dense=dense["dense"], qmatmul=fused["qmatmul"])
    reset_all_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        y = dpt(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = all_launches()
    if launches != want:
        raise AssertionError(f"static DPTNet launches {launches} != {want}")
    if tuple(y.shape) != (DPT_BATCH, 2, DPT_SEG) or not torch.isfinite(y).all():
        raise AssertionError(f"static DPTNet forward gave shape {tuple(y.shape)}, "
                             f"finite={bool(torch.isfinite(y).all())}")
    folded = fold_quantized_weights(dpt)
    with torch.inference_mode():
        y_folded = folded(x)
    if not torch.equal(y_folded, y):
        raise AssertionError(f"folded static DPTNet != fake-quant, max abs diff {(y_folded - y).abs().max().item()}")
    log(f"[73] DPTNet lstm_mode static on phase 18's weights and ranges, the sites' window observed in one train-mode "
        f"forward of 2 x {DPT_SEG // SR} s ({window['bilstm_static']} static-route launches: two a call), served "
        f"{tuple(x.shape)} -> {tuple(y.shape)}, finite, first call {first_s:.2f} s; launches "
        f"{', '.join(f'{k}={v}' for k, v in launches.items() if v)} (phase 18's, the LSTMs on the static route), all "
        f"others 0; folded bitwise equal")
    cpu_dpt = create_pretrained_model(STATIC_CFG, observer=False)
    cpu_dpt.load_state_dict(state_on_cpu(dpt))
    x1 = torch.from_numpy(dmix[:1, :STATIC_CPU_SEG])  # the CPU's plain static recurrence is the phase's longest part
    with torch.inference_mode():
        y_card, y_cpu = dpt(x1.to(dev)).cpu(), cpu_dpt(x1)
    snr = snr_db(y_cpu, y_card)
    if not bool((snr >= 20).all()):
        raise AssertionError(f"static DPTNet card vs CPU SNR {snr.tolist()} dB < 20 dB")
    floor = (snr.min().item(), (y_card - y_cpu).abs().mean().item() / out_step(dpt))
    log(f"[73] static DPTNet card vs CPU at 1 x {STATIC_CPU_SEG}: SNR {[round(v, 2) for v in snr.flatten().tolist()]} dB (>= 20), "
        f"mean {floor[1]:.4f} output steps")
    layers = 2 * dpt.layer
    int8_run = no_launches(act=layers, bilstm_static=layers, int8_mm=dptnet_int8_sites(dpt))
    # the int8 engine against the fake-quant forward's floor; its LSTMs are the forward's, so no CPU run of its own
    engines = int8_engines_vs_fake_quant(73, "DPTNet (static)", dpt, None, x, y, floor, int8_run,
                                         DPT_INT8_CARD_VS_CPU_DB, dtypes=("float32",))
    audio_s = DPT_BATCH * DPT_SEG / SR
    times = {}
    for label, fn in (("fake_quant", dpt), ("folded", folded), ("int8 float32", engines["float32"])):
        with torch.inference_mode():
            times[label] = ms = cuda_ms(lambda: fn(x), 3)
        log(f"[73] static DPTNet throughput {label}: {audio_s / (ms / 1000):.1f} sec-audio/s ({ms:.1f} ms per forward "
            f"of {DPT_BATCH} x {DPT_SEG // SR} s) on {smi}")
    state = state_on_cpu(dpt)
    del engines, folded, dpt, y, y_folded, x
    torch.cuda.empty_cache()
    return {"serve": launches, "int8": int8_run, "state": state, "ms": times}


def dynamic_step_profile(dev) -> str:
    """Where a dynamic-mode step goes: the device kernels and device time of one step of the plain dynamic loop
    at the row shape's batch (torch.profiler), against the step's wall time."""
    T, B, H = 8, 2064, 128
    gen = torch.Generator(device=dev).manual_seed(74)
    ih = [torch.randn(T, B, 4 * H, device=dev, generator=gen) * 0.5 for _ in range(2)]
    w = [(torch.rand(H, 4 * H, device=dev, generator=gen) * 2 - 1) / math.sqrt(H) for _ in range(2)]
    with torch.no_grad():
        lk.bilstm_dynamic_sequence(ih[0], ih[1], w[0], w[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            lk.bilstm_dynamic_sequence(ih[0], ih[1], w[0], w[1])
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / T
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(e, "device_time_total", 0.0) for e in events) / 1e3 / T
    if not events or not busy:
        return f"{wall:.2f} ms a step of wall time (the profiler saw no device time)"
    return (f"{len(events) / T:.0f} device kernels a step, {busy:.3f} ms of device time a step against {wall:.2f} ms "
            f"of wall time (the profiled steps, both directions at B' {B})")


def serve_dynamic(dev, smi: str, static_state: dict) -> dict:
    """Phase 74: a dynamic-mode DPTNet on phase 73's weights and act ranges, served at 8 x 4 s and card vs CPU, and one
    KD step at DYNAMIC_TRAIN_LAYERS dual-path layers. Returns the launches of the forward and of the step."""
    dyn = create_pretrained_model(DYNAMIC_CFG, observer=False, device=dev)
    dyn.load_state_dict({k: v for k, v in static_state.items() if "site_" not in k})
    if {m.mode for m in dyn.modules() if isinstance(m, QLSTM)} != {"dynamic"}:
        raise AssertionError("the dynamic-mode DPTNet's LSTMs are not dynamic")
    counts, dense, fused = count_quantizers(dyn.modules()), dense_quantizers(dyn), fused_convs(dyn)
    n_mha = sum(isinstance(m, QMultiheadAttention) for m in dyn.modules())
    want = no_launches(act=counts["act"] - 3 * n_mha - dense["act"] - fused["act"], weight=1, attention=n_mha,
                       dense=dense["dense"], qmatmul=fused["qmatmul"])
    dmix, _ = synth_batch(np.random.default_rng(74), DPT_BATCH, 2, DPT_SEG)
    x = torch.from_numpy(dmix).to(dev)
    reset_all_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    with torch.inference_mode():
        y = dyn(x)
    end.record()
    torch.cuda.synchronize()
    wall_s, ms = time.perf_counter() - t0, start.elapsed_time(end)  # one forward of seconds: a warm-up costs as much
    launches = all_launches()
    if launches != want:
        raise AssertionError(f"dynamic DPTNet launches {launches} != {want}")
    if tuple(y.shape) != (DPT_BATCH, 2, DPT_SEG) or not torch.isfinite(y).all():
        raise AssertionError(f"dynamic DPTNet forward gave shape {tuple(y.shape)}, "
                             f"finite={bool(torch.isfinite(y).all())}")
    steps = sum(T for _, T, _, _ in dpt_lstm_shapes(DPT_BATCH, DPT_SEG, dyn)) * dyn.layer
    log(f"[74] DPTNet lstm_mode dynamic on phase 73's weights and act ranges {tuple(x.shape)} -> {tuple(y.shape)}, "
        f"finite; launches {', '.join(f'{k}={v}' for k, v in launches.items() if v)}, no LSTM kernel (the plain loop); "
        f"{ms:.1f} ms per forward of {DPT_BATCH} x {DPT_SEG // SR} s ({DPT_BATCH * DPT_SEG / SR / (ms / 1000):.2f} "
        f"sec-audio/s, CUDA events; {wall_s:.2f} s on the host clock) on {smi}: {steps} recurrence steps a forward, "
        f"{ms / steps:.3f} ms a step; {dynamic_step_profile(dev)}")
    shallow = {**DYNAMIC_CFG, "layer": DYNAMIC_CPU_LAYERS}
    full = state_on_cpu(dyn)
    card_dyn, cpu_dyn = (create_pretrained_model(shallow, observer=False, device=d) for d in (dev, "cpu"))
    for net in (card_dyn, cpu_dyn):
        net.load_state_dict({k: full[k] for k in net.state_dict()})
    x1 = torch.from_numpy(dmix[:1, :SR])
    with torch.inference_mode():
        y_card, y_cpu = card_dyn(x1.to(dev)).cpu(), cpu_dyn(x1)
    snr = snr_db(y_cpu, y_card)
    if not bool((snr >= 20).all()):
        raise AssertionError(f"dynamic DPTNet card vs CPU SNR {snr.tolist()} dB < 20 dB")
    log(f"[74] dynamic DPTNet (its first {DYNAMIC_CPU_LAYERS} dual-path layers) card vs CPU at 1 x {SR}: SNR "
        f"{[round(v, 2) for v in snr.flatten().tolist()]} dB (>= 20), mean "
        f"{(y_card - y_cpu).abs().mean().item() / out_step(card_dyn):.4f} output steps")
    del dyn, y, x, cpu_dyn, card_dyn
    torch.cuda.empty_cache()
    cfg = train_cfg({**DYNAMIC_CFG, "layer": DYNAMIC_TRAIN_LAYERS})
    model, teacher = create_model_and_teacher(cfg, generator=torch.Generator().manual_seed(74))
    base = train_launches(model, teacher)
    n_lstm = sum(isinstance(m, QLSTM) for m in model.modules())
    step_want = {**base, "bilstm": base["bilstm"] - n_lstm}  # the teacher's LSTMs on K7, the student's plain
    state = new_train_state(model.to(dev), teacher.to(dev))
    mix, src = synth_batch(np.random.default_rng(74), 1, 2, DPT_TRAIN_SEG)
    reset_all_launches()
    t0 = time.perf_counter()
    metrics = make_train_step(TrainConfig())(state, torch.from_numpy(mix).to(dev), torch.from_numpy(src).to(dev))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    step_run = all_launches()
    if step_run != step_want or not np.isfinite(float(metrics["loss"])) or state.skipped:
        raise AssertionError(f"dynamic DPTNet KD step: launches {step_run} (want {step_want}), loss "
                             f"{float(metrics['loss'])}, skipped {state.skipped}")
    log(f"[74] dynamic DPTNet, its first {DYNAMIC_TRAIN_LAYERS} dual-path layer(s), one KD step of 1 x "
        f"{DPT_TRAIN_SEG // SR} s in {seconds:.1f} s: loss {float(metrics['loss']):.3f} dB, finite, every gradient "
        f"finite: {all(bool(torch.isfinite(p.grad).all()) for p in state.model.parameters() if p.grad is not None)}; "
        f"launches {', '.join(f'{k}={v}' for k, v in step_run.items() if v)} (the teacher's LSTMs on K7), all others 0")
    del state, model, teacher
    torch.cuda.empty_cache()
    return {"serve": launches, "train": step_run}


def lstm_modes(dev, smi: str, dpt_state: dict) -> dict:
    """Phases 72-74, the LSTM's static and dynamic modes. Returns phase 72's results and the launches of phases 73's
    and 74's runs."""
    dpt = create_model(DPTNET_CFG, QuantSpec())
    shapes = dpt_lstm_shapes(DPT_BATCH, DPT_SEG, dpt)
    stream_shapes = [(f"stream {side}", T, B, H) for side, T, B, H in dpt_lstm_shapes(1, STREAM_SEGMENT, dpt)]
    k6, k7 = check_static_route(dev, shapes, dpt.layer, stream_shapes)  # 72.
    torch.cuda.empty_cache()
    clock("72")
    train_run = static_train(dev)  # 73.
    clock("73 training")
    served = serve_static(dev, smi, dpt_state)
    clock("73 serving")
    dynamic = serve_dynamic(dev, smi, served["state"])  # 74.
    clock("74")
    return {"k6": k6, "k7": k7, "train": train_run, "serve": served["serve"], "int8": served["int8"],
            "ms": served["ms"], "dynamic": dynamic}


# ---------------------------------------------------------------------------------------------------------------
# 75-78. data parallelism over torch.distributed (fqss_tpu_torch/parallel/mesh.py)
# ---------------------------------------------------------------------------------------------------------------

DDP_RANKS = 2  # two processes sharing cuda:0 over gloo (NCCL takes one rank a card)
DDP_STEPS = 3  # through TRAIN_CFG's observer window of 3 steps
DDP_LOSS_DB = 1e-3
DDP_GRAD_COS = 0.99999
DDP_STATIC_CFG = {**STATIC_CFG, "layer": 1}  # phase 73's static DPTNet at one dual-path layer
DDP_DYNAMIC_CFG = {**DYNAMIC_CFG, "layer": 1}
DDP_DPT_BATCH = DDP_RANKS  # phases 77 and 79: one row a rank
DDP_DYNAMIC_SEG = DPT_TRAIN_SEG // 2  # phase 79: 1.5 s (at 3 s the ranks took 12.8-14.5 s)
DDP_STATIC_SEG = DPT_TRAIN_SEG // 2  # phase 77: 1.5 s (at 3 s its step took 20-25 s on the ranks)
DDP_OLA = dict(seconds=60, segment=16000, overlap=0.25, chunk_batch=8)  # the flagship's request OLA, 60 s
DDP_WORKER = [sys.executable, os.path.abspath(__file__)]  # a rank's command, before its arguments
FSDP_MIN_SIZE = 2**12  # JAX's default: phase 75's FSDP steps shard every leaf of 4096 elements or more
FSDP_NORM_REL = 1e-6
FSDP_STATE_REL = 1e-6  # of each tensor's largest magnitude, after a step whose clip binds
# The kernels each data-parallel path must launch (the counters of all_launches()).
DDP_PATH_KERNELS = {"kd": ("act", "weight", "act_bwd", "weight_bwd"), "fsdp": ("act", "weight", "act_bwd", "weight_bwd"),
                    "nccl": ("act", "weight", "act_bwd", "weight_bwd"),
                    "static": ("act", "weight", "act_bwd", "weight_bwd", "bilstm_static", "bilstm", "attention",
                               "dense", "dense_mask"),
                    "ola": ("act", "weight")}


def act_observers(model) -> dict:
    """Every act quantizer's ranges and counter (what its observer writes), on the CPU."""
    return {f"{n}.{k}": v.detach().cpu().clone() for n, m in model.named_modules() if isinstance(m, ActQuantizer)
            for k, v in m.state_dict().items()}


def site_observers(model) -> dict:
    """Every static LSTM direction's site ranges and counter, on the CPU."""
    return {f"{n}.{k}": getattr(m, k).detach().cpu().clone() for n, m in model.named_modules()
            if "site_n_iter" in m._buffers for k in ("site_min", "site_max", "site_n_iter")}


def learned_keys(model) -> list[str]:
    """The names of the parameters that the act quantizers' observers do not write."""
    acts = {f"{n}.{k}" for n, m in model.named_modules() if isinstance(m, ActQuantizer) for k, _ in
            m.named_parameters()}
    return [k for k, _ in model.named_parameters() if k not in acts]


def learned_params(model) -> dict:
    """The parameters that the act quantizers' observers do not write, on the CPU."""
    keys = set(learned_keys(model))
    return {k: p.detach().cpu().clone() for k, p in model.named_parameters() if k in keys}


def ddp_batches(batch: int, seg: int, steps: int, seed: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    rng = np.random.default_rng(seed)
    return [tuple(map(torch.from_numpy, synth_batch(rng, batch, 2, seg))) for _ in range(steps)]


def fsdp_rule_elements(state: TrainState, size: int, min_size: int) -> dict:
    """What a rank should hold between steps once ``state`` (whole) is sharded over ``size`` data ranks at
    ``min_size``, by JAX's rule (fsdp.fsdp_sharding; the quantizers' parameters replicated): per parameter name the
    elements of the student's, and the teacher's total; the persistent buffers' names (the sharded weights that a weight
    quantizer reads)."""
    quantizers = {id(p) for m in state.model.modules() if isinstance(m, (ActQuantizer, WeightQuantizer))
                  for p in m.parameters()}

    def held(p) -> int:
        sharded = id(p) not in quantizers and fsdp.fsdp_sharding(p.shape, size, min_size) is not None
        return p.numel() // size if sharded else p.numel()

    names = {id(m): n for n, m in state.model.named_modules()}
    params = dict(state.model.named_parameters())
    student = {k: held(p) for k, p in params.items()}
    read = {f"{names[id(layer)]}.{wname}" for layer, _, wname in weight_quantizer_sites(state.model)}
    return {"student": student, "teacher": sum(held(p) for p in state.teacher.parameters()),
            "buffers": {k: params[k].numel() for k in read if student[k] != params[k].numel()}}


def ddp_kd_steps(dev, cfg: dict, seed: int, batches: list, mesh=None, forced: list | None = None,
                 observers=act_observers, fsdp_min_size: int | None = None) -> dict:
    """KD steps of ``cfg``'s model and teacher from ``seed`` on ``batches`` (this rank's rows of each under
    ``mesh``): per step the learned parameters before it, the observers' state after its forward, the loss, the
    gradient's global norm before the clip (the step's ``grad_norm``), the whole reduced gradient before the clip
    and after it, the host-clock seconds (after a synchronize) and the whole state after it; the launches of the
    run (counted from 0) and the state after it. ``forced``: the learned parameters to take before each step
    (another run's). ``fsdp_min_size``: the state sharded over ``mesh``'s data ranks (parallel/fsdp.py), every
    tensor recorded whole, and what the rank holds after the steps beside JAX's rule.

    The gradient before the clip is read inside the step, where the trainer calls ``clip_by_global_norm_``: the
    replicated step's norm (float32 norms) and a sharded step's (float64 sums over the slices) may differ in their
    last bit, and then the gradients after the clip differ by that scale alone."""
    model, teacher = create_model_and_teacher(cfg, generator=torch.Generator().manual_seed(seed))
    state = new_train_state(model.to(dev), teacher.to(dev))
    out = {"before": [], "loss": [], "norm": [], "reduced": [], "grads": [], "seconds": [], "after": []}
    if fsdp_min_size is not None:
        out["rule"] = fsdp_rule_elements(state, mesh.size, fsdp_min_size)
        fsdp.shard_state_fsdp(state, mesh, min_size=fsdp_min_size)
    step = make_train_step(TrainConfig(), mesh)
    seen = []
    hook = state.model.register_forward_hook(lambda m, args, out: seen.append(observers(m)))
    flat = lambda grads: torch.cat([g.flatten().double() for g in grads.values()])  # noqa: E731
    clip = trainer_module.clip_by_global_norm_

    def recorded(grads, max_norm, norm=None):  # the reduced gradients, then the trainer's own clip
        out["reduced"].append(flat(shards.whole_gradients(state.model)))
        return clip(grads, max_norm, norm)

    trainer_module.clip_by_global_norm_ = recorded
    reset_all_launches()
    try:
        for i, (mix, src) in enumerate(batches):
            if forced is not None:  # the learned parameters before the step are then the forced ones
                shards.load_whole_state_dict(state.model, forced[i])
                out["before"].append(forced[i])
            else:
                whole = shards.whole_state_dict(state.model)
                out["before"].append({k: whole[k] for k in learned_keys(state.model)})
            rows = mesh.rows(len(mix)) if mesh is not None else slice(None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, mix[rows].to(dev), src[rows].to(dev))
            torch.cuda.synchronize()
            out["seconds"].append(time.perf_counter() - t0)
            out["loss"].append(float(metrics["loss"]))
            out["norm"].append(float(metrics["grad_norm"]))
            out["grads"].append(flat(shards.whole_gradients(state.model)))
            out["after"].append(shards.whole_state_dict(state.model))
    finally:
        trainer_module.clip_by_global_norm_ = clip
    out["launches"] = all_launches()
    hook.remove()
    out["observed"] = seen
    out["state"] = out["after"][-1]
    if fsdp_min_size is not None:
        out["held"] = fsdp.held_elements(state)
        out["stepped"] = sorted(k for k, p in state.model.named_parameters() if p in state.optimizer.state)
        out["buffers"] = {k: v.numel() for k, v in fsdp.gather_buffers(state.model).items()}
    if not np.isfinite(out["loss"]).all() or state.skipped:
        raise AssertionError(f"KD steps: losses {out['loss']}, skipped {state.skipped}")
    del state, model, teacher
    torch.cuda.empty_cache()
    return out


def ddp_ola_mix() -> np.ndarray:
    return synth_batch(np.random.default_rng(78), 1, 2, DDP_OLA["seconds"] * SR)[0]


def ddp_ola(dev, state: dict, mesh, chunk_batch: int) -> tuple[np.ndarray, dict, float]:
    """Phase 78's OLA: the flagship with ``state`` (eval mode) on the 60 s mixture, sharded over ``mesh``; the
    separation, the launches (from 0) and the host-clock seconds."""
    model = create_model(TRAIN_CFG, quant_spec_from_cfg(TRAIN_CFG))
    model.load_state_dict(state)
    model = model.to(dev).eval()
    mix = ddp_ola_mix()
    reset_all_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ola_infer(model, mix, n_srcs=2, segment=DDP_OLA["segment"], overlap=DDP_OLA["overlap"],
                    chunk_batch=chunk_batch, mesh=mesh, device=dev)
    seconds = time.perf_counter() - t0
    return out, all_launches(), seconds


def ddp_dynamic(dev, mesh) -> tuple[torch.Tensor, float]:
    """Phase 79: the dynamic-cell DPTNet at one dual-path layer, an eval forward of 2 x 1.5 s (one row a rank under
    ``mesh``: 12 min/max reductions over the ranks a recurrence step), gathered; and its host-clock seconds."""
    model = create_model(DDP_DYNAMIC_CFG, quant_spec_from_cfg(DDP_DYNAMIC_CFG),
                         generator=torch.Generator().manual_seed(79)).to(dev).eval()
    (mix, _), = ddp_batches(DDP_DPT_BATCH, DDP_DYNAMIC_SEG, 1, 79)
    rows = mesh.rows(DDP_DPT_BATCH) if mesh is not None else slice(None)
    with torch.inference_mode(), dp.sharded(mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # one forward, no warm-up: the plain loop compiles nothing, and a forward is seconds
        y = dp.gather_rows(model(mix[rows].to(dev)), DDP_DPT_BATCH)
        torch.cuda.synchronize()
    return y.cpu(), time.perf_counter() - t0


def ddp_worker(out_dir: str, dev: torch.device | None = None) -> None:
    """A rank of phases 75, 77 and 78 (``python3 chip_smoke.py --ddp-worker DIR`` with torchrun's variables):
    gloo on cuda:0 (``dev``: another device, for a rehearsal); what it saw goes to DIR/rank<r>.pt (the learned
    parameters and gradients on rank 0 only)."""
    if dev is None:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
        dev = torch.device("cuda", 0)
    infer.disable_tf32()
    torch.backends.cudnn.deterministic = True  # as the one-process runs it is held to (deterministic_cudnn)
    mesh = dp.init_distributed(dev, backend="gloo")
    try:
        _build.library()
        log(f"rank {mesh.rank}: in the group after {time.perf_counter() - _CLOCK['start']:.1f} s")
        batches = ddp_batches(TRAIN_BATCH, TRAIN_SEG, DDP_STEPS, 75)
        a = ddp_kd_steps(dev, TRAIN_CFG, 75, batches, mesh)
        clock(f"75 on rank {mesh.rank}")
        # 75, FSDP: the same steps with the state sharded over the two ranks, each from the DDP run's learned
        # parameters before it
        f = ddp_kd_steps(dev, TRAIN_CFG, 75, batches, mesh, forced=a["before"], fsdp_min_size=FSDP_MIN_SIZE)
        clock(f"75 (FSDP) on rank {mesh.rank}")
        c = ddp_kd_steps(dev, train_cfg(DDP_STATIC_CFG), 77, ddp_batches(DDP_DPT_BATCH, DDP_STATIC_SEG, 1, 77), mesh,
                         observers=site_observers)
        clock(f"77 on rank {mesh.rank}")
        ola, ola_launches, ola_s = ddp_ola(dev, a["state"], mesh, DDP_OLA["chunk_batch"])
        dynamic, dynamic_s = ddp_dynamic(dev, mesh)
        clock(f"78-79 on rank {mesh.rank}")
        if mesh.rank:
            for run in (a, c, f):
                del run["before"], run["reduced"], run["grads"], run["after"]
        torch.save({"a": a, "f": f, "c": c, "ola": torch.from_numpy(ola), "ola_launches": ola_launches, "ola_s": ola_s,
                    "dynamic": dynamic, "dynamic_s": dynamic_s}, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    finally:
        dp.shutdown()


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block: its default convolution backward sums with atomics, so
    one process's step already differs from itself in the last bits from run to run (phase 76 shows it)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def same_steps(a: dict, b: dict) -> bool:
    """Whether two runs of ddp_kd_steps gave the same losses, gradients and state, bit for bit."""
    return (a["loss"] == b["loss"] and all(torch.equal(g, p) for g, p in zip(a["grads"], b["grads"]))
            and all(torch.equal(a["state"][k], v) for k, v in b["state"].items()))


def nccl_pipeline(dev, mesh) -> tuple[bool, float, dict]:
    """Phase 76's pipeline call: two full-width transformer layers (E 256, 8 heads, FFN 1024, seeds 76 and 77) as one
    stage on ``mesh``'s group (its collectives run), against the same layers applied in order without a group, on
    2 x 4 s of tokens (4 x 250 x 256); whether the outputs are bitwise equal, their max |diff|, the call's launches."""
    layers = [TransformerLayer(256, 1024, 8, generator=torch.Generator().manual_seed(76 + i)).to(dev) for i in range(2)]
    x = torch.randn(4, 250, 256, generator=torch.Generator().manual_seed(76)).to(dev)
    with torch.no_grad():
        reset_all_launches()
        y = pp.pipeline_layer_module(layers, x, pp.pipeline_mesh(mesh, 1))
        launches = all_launches()
        want = sequential_stack(layers, x)
    return torch.equal(y, want), float((y - want).abs().max()), launches


def sequential_stack(layers, x: torch.Tensor) -> torch.Tensor:
    """``layers`` applied in order as a pipeline's stages apply them (one grouped weight pass, no state writes)."""
    stack = torch.nn.ModuleList(layers)
    with read_only(), weight_pass(stack):
        for layer in stack:
            x = layer(x)
    return x


def nccl_one_rank(dev) -> tuple[dict, dict, dict]:
    """Phase 76: the flagship's DDP_STEPS KD steps at 16 x 3 s in this process with no process group, then on a
    one-rank NCCL group (init_process_group("nccl") at world size 1, every collective run): bitwise equal, with
    cuDNN deterministic (first, with cuDNN's defaults, the run without a group against itself). On the same group
    one FSDP step (its gather and reduce-scatter on NCCL) against the first step without a group, and one
    single-stage pipeline call (nccl_pipeline). Returns the grouped run's launches, the FSDP step's and the
    pipeline call's."""
    batches = ddp_batches(TRAIN_BATCH, TRAIN_SEG, DDP_STEPS, 76)
    default = [ddp_kd_steps(dev, TRAIN_CFG, 76, batches[:1]) for _ in range(2)]
    log(f"[76] with cuDNN's default algorithms one step without a group against itself: bitwise "
        f"{same_steps(*default)} (whole-gradient max |diff| {float((default[0]['grads'][0] - default[1]['grads'][0]).abs().max()):.3g})")
    del default
    with deterministic_cudnn():
        plain = ddp_kd_steps(dev, TRAIN_CFG, 76, batches)
    saved = {k: os.environ.get(k) for k in dp.ENV + ("LOCAL_RANK",)}
    os.environ.update(dp.rank_env(0, 1, dp.free_port()))
    try:
        mesh = dp.init_distributed(dev)
        try:
            if mesh is None or (mesh.backend, mesh.size) != ("nccl" if dev.type == "cuda" else "gloo", 1):
                raise AssertionError(f"a one-rank NCCL group expected, got {mesh}")
            with deterministic_cudnn():
                grouped = ddp_kd_steps(dev, TRAIN_CFG, 76, batches, mesh)
                sharded = ddp_kd_steps(dev, TRAIN_CFG, 76, batches[:1], mesh, fsdp_min_size=FSDP_MIN_SIZE)
            piped, piped_diff, pp_launches = nccl_pipeline(dev, mesh)
        finally:
            dp.shutdown()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if not same_steps(grouped, plain):
        raise AssertionError(f"the one-rank NCCL group's steps differ from the run without a group: losses "
                             f"{grouped['loss']} against {plain['loss']}")
    log(f"[76] the flagship's {DDP_STEPS} KD steps at {TRAIN_BATCH} x {TRAIN_SEG // SR} s on a one-rank NCCL group "
        f"(every observer's min/max, the loss's batch means and the gradients through an all_reduce): losses, "
        f"gradients and the whole state bitwise equal to the run without a group (cuDNN deterministic); "
        f"{', '.join(f'{k}={v}' for k, v in grouped['launches'].items() if v)}")
    binds = not plain["norm"][0] < TrainConfig().grad_clip
    rel = max(float((sharded["after"][0][k] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
              for k, w in plain["after"][0].items() if w.is_floating_point())
    norm_rel = abs(sharded["norm"][0] - plain["norm"][0]) / plain["norm"][0]
    same = (sharded["loss"][0] == plain["loss"][0] and torch.equal(sharded["reduced"][0], plain["reduced"][0])
            and sharded["observed"][0].keys() == plain["observed"][0].keys()
            and not bitwise_mismatches(sharded["observed"][0], plain["observed"][0]))
    state_ok = rel <= FSDP_STATE_REL if binds else not bitwise_mismatches(sharded["after"][0], plain["after"][0])
    log(f"[76] on the same one-rank NCCL group, one FSDP step (every parameter of {FSDP_MIN_SIZE} elements or more "
        f"gathered and its gradient reduce-scattered over NCCL): the observers, the loss and the gradient before the "
        f"clip bitwise the first step without a group: {same}; global norm relative difference {norm_rel:.2e} (<= "
        f"{FSDP_NORM_REL}); the clip binds: {binds}, the state after it: largest "
        f"relative difference {rel:.2e}; one single-stage pipeline call of two full-width transformer layers (its "
        f"output broadcast over NCCL) bitwise the layers in order: {piped} (max |diff| {piped_diff:.3g})")
    if not same or norm_rel > FSDP_NORM_REL or not state_ok or not piped:
        raise AssertionError(f"phase 76's FSDP and pipeline rules: step {same}, norm {norm_rel}, state {rel}, "
                             f"pipeline {piped_diff}")
    return grouped["launches"], sharded["launches"], pp_launches


def bitwise_mismatches(got: dict, want: dict) -> list[str]:
    if got.keys() != want.keys():
        return ["the keys differ"]
    return [k for k in want if not torch.equal(got[k], want[k])]


def fsdp_against_ddp(ranks: list[dict], one: dict, smi: str) -> None:
    """Phase 75's FSDP steps (``f``) against the DDP steps on the same ranks (``a``) and against the one-process
    run (``one``, from the DDP run's learned parameters, as the FSDP steps are); raises after the log lines where a
    rule misses."""
    a, f = ranks[0]["a"], ranks[0]["f"]
    observed = [(i, k) for i, (g, w) in enumerate(zip(f["observed"], a["observed"])) for k in bitwise_mismatches(g, w)]
    loss_equal = [g == w for g, w in zip(f["loss"], a["loss"])]
    grads_equal = [torch.equal(g, w) for g, w in zip(f["reduced"], a["reduced"])]
    norm_rel = [abs(g - w) / w for g, w in zip(f["norm"], a["norm"])]
    binds = [not w < TrainConfig().grad_clip for w in a["norm"]]
    state_bitwise = [not bitwise_mismatches(g, w) for g, w in zip(f["after"], a["after"])]
    state_rel = [max((float((g[k] - w[k]).abs().max()) / max(float(w[k].abs().max()), 1e-30)
                      for k in w if w[k].is_floating_point()), default=0.0) for g, w in zip(f["after"], a["after"])]
    state_ok = all(ok if not bind else rel <= FSDP_STATE_REL for ok, bind, rel in zip(state_bitwise, binds, state_rel))
    across = [k for r in ranks[1:] for k in bitwise_mismatches(r["f"]["state"], f["state"])]
    dloss = [abs(g - w) for g, w in zip(f["loss"], one["loss"])]
    cos = [float(g @ w / (g.norm() * w.norm())) for g, w in zip(f["grads"], one["grads"])]
    held, want = [], []
    for r in ranks:
        rule = r["f"]["rule"]
        held.append(r["f"]["held"])
        want.append({"params": sum(rule["student"].values()), "teacher": rule["teacher"],
                     "moments": 2 * sum(rule["student"][k] for k in r["f"]["stepped"]),
                     "buffers": sum(rule["buffers"].values())})
    names_ok = all(set(r["f"]["buffers"]) == set(r["f"]["rule"]["buffers"]) for r in ranks)
    whole = sum(v.numel() for k, v in f["state"].items() if k in f["rule"]["student"])
    log(f"[75] FSDP: the same {DDP_STEPS} KD steps on the same {DDP_RANKS} ranks with the state sharded over them "
        f"(min_size {FSDP_MIN_SIZE}: {sum(v != f['state'][k].numel() for k, v in f['rule']['student'].items())} of "
        f"{len(f['rule']['student'])} parameters, the teacher's and Adam's moments with them), each step from the DDP "
        f"run's learned parameters: the act observers after every forward bitwise the DDP steps': {not observed}; loss "
        f"bitwise {loss_equal}; reduced gradients before the clip bitwise {grads_equal}; global norm relative "
        f"difference {[f'{v:.2e}' for v in norm_rel]} (<= {FSDP_NORM_REL}); the clip binds {binds}; whole state after "
        f"each step bitwise {state_bitwise}, largest relative difference {[f'{v:.2e}' for v in state_rel]} (<= "
        f"{FSDP_STATE_REL} where the clip binds); rank 1's whole state bitwise rank 0's: {not across}")
    log(f"[75] FSDP against one process (phase 75's rules): loss |diff| {[f'{v:.2e}' for v in dloss]} dB (<= "
        f"{DDP_LOSS_DB}), whole-gradient cosine {[f'{v:.7f}' for v in cos]} (>= {DDP_GRAD_COS}); held between steps "
        f"per rank {held} against the rule's {want} (the student's whole parameters {whole} elements), the persistent "
        f"gather buffers {sorted(f['buffers'])}; step "
        f"{[round(1e3 * max(r['f']['seconds'][i] for r in ranks), 1) for i in range(DDP_STEPS)]} ms against the DDP "
        f"steps' {[round(1e3 * max(r['a']['seconds'][i] for r in ranks), 1) for i in range(DDP_STEPS)]} ms (two ranks "
        f"sharing one card), on {smi}")
    if (observed or not all(loss_equal) or not all(grads_equal) or max(norm_rel) > FSDP_NORM_REL or not state_ok
            or across or max(dloss) > DDP_LOSS_DB or min(cos) < DDP_GRAD_COS or held != want or not names_ok):
        raise AssertionError(f"phase 75's FSDP rules: observers {observed[:5]}, loss {loss_equal}, gradients "
                             f"{grads_equal}, norm {norm_rel}, state {state_rel}, across ranks {across[:5]}, against "
                             f"one process {dloss} {cos}, held {held} against {want}")


def data_parallel(dev, smi: str) -> dict:
    """Phases 75-79: two ranks on cuda:0 over gloo against one process, and a one-rank NCCL group. Returns each
    path's launches."""
    nccl, nccl_fsdp, nccl_pp = nccl_one_rank(dev)  # 76.
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks("--ddp-worker", DDP_RANKS, tmp, "75-79")
    clock("76, the ranks of 75, 77-79")

    # 75. the flagship's KD steps: the ranks against one process on the same 16 rows, from the ranks' learned
    # parameters before each step (the ranks and the one-process runs of 75-79 with cuDNN deterministic)
    a = ranks[0]["a"]
    with deterministic_cudnn():
        one = ddp_kd_steps(dev, TRAIN_CFG, 75, ddp_batches(TRAIN_BATCH, TRAIN_SEG, DDP_STEPS, 75),
                           forced=a["before"])
    across = [k for r in ranks[1:] for k in bitwise_mismatches(r["a"]["state"], a["state"])]
    observed = [(i, k) for i, (g, w) in enumerate(zip(a["observed"], one["observed"]))
                for k in bitwise_mismatches(g, w)]
    dloss = [abs(g - w) for g, w in zip(a["loss"], one["loss"])]
    cos = [float(g @ w / (g.norm() * w.norm())) for g, w in zip(a["grads"], one["grads"])]
    rel = [float((g - w).norm() / w.norm()) for g, w in zip(a["grads"], one["grads"])]
    two_s = [max(r["a"]["seconds"][i] for r in ranks) for i in range(DDP_STEPS)]
    n_obs = sum(k.endswith("n_iter") for k in a["observed"][0])
    log(f"[75] the flagship's KD steps at {TRAIN_BATCH} x {TRAIN_SEG // SR} s through its {DDP_STEPS}-step window, "
        f"{DDP_RANKS} ranks x {TRAIN_BATCH // DDP_RANKS} rows on cuda:0 over gloo against one process (from the "
        f"ranks' learned parameters before each step): {n_obs} act observers' ranges and counters "
        f"bitwise equal after every forward: {not observed} ({len(observed)} values of {len(a['observed'][0])} differ); rank 1's whole state bitwise "
        f"rank 0's: {not across}; loss |diff| {[f'{v:.2e}' for v in dloss]} dB (<= {DDP_LOSS_DB}); whole-gradient "
        f"cosine {[f'{v:.7f}' for v in cos]} (>= {DDP_GRAD_COS}), relative L2 {[f'{v:.2e}' for v in rel]}")
    log(f"[75] step times, two ranks sharing one card (not a speed-up): {[round(1e3 * v, 1) for v in two_s]} ms; one "
        f"process: {[round(1e3 * v, 1) for v in one['seconds']]} ms (host clock, each after a synchronize) on {smi}")
    if observed or across or max(dloss) > DDP_LOSS_DB or min(cos) < DDP_GRAD_COS:
        raise AssertionError(f"phase 75's rules: observers {observed[:5]}, across ranks {across[:5]}, loss {dloss}, "
                             f"cosine {cos}")
    fsdp_against_ddp(ranks, one, smi)

    # 77. DPTNet lstm_mode static at one dual-path layer, 2 x 1.5 s, one row a rank
    c = ranks[0]["c"]
    with deterministic_cudnn():
        one_c = ddp_kd_steps(dev, train_cfg(DDP_STATIC_CFG), 77, ddp_batches(DDP_DPT_BATCH, DDP_STATIC_SEG, 1, 77),
                             observers=site_observers)
    sites = bitwise_mismatches(c["observed"][0], one_c["observed"][0])
    across_c = [k for r in ranks[1:] for k in bitwise_mismatches(r["c"]["state"], c["state"])]
    cos_c = float(c["grads"][0] @ one_c["grads"][0] / (c["grads"][0].norm() * one_c["grads"][0].norm()))
    log(f"[77] DPTNet lstm_mode static at one dual-path layer, a KD step of {DDP_DPT_BATCH} x {DDP_STATIC_SEG / SR} s, "
        f"{DDP_DPT_BATCH // DDP_RANKS} row(s) a rank: the {len(c['observed'][0])} site ranges and counters after the forward bitwise equal to one "
        f"process's: {not sites} ({len(sites)} differ); rank 1's whole state bitwise rank 0's: {not across_c}; loss "
        f"{c['loss'][0]:.5f} against {one_c['loss'][0]:.5f} dB, whole-gradient cosine {cos_c:.7f}; step "
        f"{1e3 * max(r['c']['seconds'][0] for r in ranks):.1f} ms on two ranks sharing one card (not a speed-up), "
        f"{1e3 * one_c['seconds'][0]:.1f} ms in one process, on {smi}")
    if sites or across_c:
        raise AssertionError(f"phase 77's rule: sites {sites[:5]}, across ranks {across_c[:5]}")

    # 78. sharded OLA of 60 s through the flagship (phase 75's state after its window), chunk_batch 8 a rank,
    # against one process at 16 (the same blocks)
    with deterministic_cudnn():
        want, one_launches, one_s = ddp_ola(dev, a["state"], None, DDP_RANKS * DDP_OLA["chunk_batch"])
    got = [r["ola"].numpy() for r in ranks]
    equal = [np.array_equal(g, want) for g in got]
    diff = max(float(np.abs(g - want).max()) for g in got)
    log(f"[78] sharded ola_infer of a {DDP_OLA['seconds']} s mixture through the flagship (segment "
        f"{DDP_OLA['segment']}, overlap {DDP_OLA['overlap']}), chunk_batch {DDP_OLA['chunk_batch']} on each of "
        f"{DDP_RANKS} ranks against one process at {DDP_RANKS * DDP_OLA['chunk_batch']}: every rank's separation "
        f"bitwise equal: {equal} (max |diff| {diff:.3g}); {1e3 * max(r['ola_s'] for r in ranks):.1f} ms on two ranks "
        f"sharing one card, {1e3 * one_s:.1f} ms in one process, on {smi}")
    if not all(equal) or not np.isfinite(want).all():
        raise AssertionError(f"phase 78's rule: bitwise {equal}, max |diff| {diff}")
    # 79. the dynamic cell's reductions: a one-layer dynamic DPTNet forward on the ranks against one process
    with deterministic_cudnn():
        one_y, one_dyn_s = ddp_dynamic(dev, None)
    if not all(torch.isfinite(r["dynamic"]).all() for r in ranks) or not torch.equal(ranks[1]["dynamic"],
                                                                                       ranks[0]["dynamic"]):
        raise AssertionError("phase 79: the ranks' dynamic forwards are not finite or differ between ranks")
    log(f"[79] DPTNet lstm_mode dynamic at one dual-path layer, an eval forward of {DDP_DPT_BATCH} x "
        f"{DDP_DYNAMIC_SEG / SR} s, {DDP_DPT_BATCH // DDP_RANKS} row(s) a rank (12 all_reduces of the sites' min and max a recurrence step): "
        f"{1e3 * max(r['dynamic_s'] for r in ranks):.1f} ms on two ranks sharing one card over gloo, "
        f"{1e3 * one_dyn_s:.1f} ms in one process, on {smi}; the ranks' output against one process's: max |diff| "
        f"{float((ranks[0]['dynamic'] - one_y).abs().max()):.3g}, bitwise {torch.equal(ranks[0]['dynamic'], one_y)}")

    sums = lambda runs: {k: sum(run[k] for run in runs) for k in runs[0]}  # noqa: E731
    paths = {"kd": sums([r["a"]["launches"] for r in ranks]), "fsdp": sums([r["f"]["launches"] for r in ranks]),
             "nccl": nccl, "nccl fsdp": nccl_fsdp, "nccl pp": nccl_pp,
             "static": sums([r["c"]["launches"] for r in ranks]), "ola": sums([r["ola_launches"] for r in ranks])}
    for path, names in {**DDP_PATH_KERNELS, "nccl fsdp": DDP_PATH_KERNELS["fsdp"], "nccl pp": PP_FLOAT_KERNELS}.items():
        idle = [k for k in names if not paths[path][k]]
        if idle:
            raise AssertionError(f"the data-parallel {path} path launched no {idle}: {paths[path]}")
    log(f"[75-78] launches on the ranks (summed), counted from 0 before each path: "
        + "; ".join(f"{path} {', '.join(f'{k}={v}' for k, v in c.items() if v)}" for path, c in paths.items()))
    return paths


# Tensor parallelism (phases 80-81): gloo ranks of this script sharing cuda:0 as a (dp, tp) grid, against one process.
TP_SIZE = 2
TP_STEPS = 2  # through a 2-step observer window, as phase 75's steps run through theirs
TP_CFG = {**SEPFORMER_CFG, "quantization": {**SEPFORMER_CFG["quantization"], "max_observations": TP_STEPS}}
TP_GRID_CFG = {**TP_CFG, "n_layers": 1}  # phase 81: one layer a block (phase 80 holds the full width)
TP_BATCH, TP_SEG = 2, 4 * SR
TP_FLOAT_DB = 100.0
TP_QAT_DB = 25.0
TP_LOSS_DB = 1e-4
TP_GRAD_COS = 0.9999
# The kernels each tensor-parallel path must launch (the counters of all_launches()).
TP_PATH_KERNELS = ("act", "weight", "act_bwd", "weight_bwd", "attention", "dense", "dense_mask", "dense_dx",
                   "dense_dwq")


# The count and host time of a rank's gloo sums over tp in a step (the layers' parallel/tp.py:_sum_over_tp, wrapped
# by time_tp_sums on the ranks): the card is synchronised before and after each, so that the time is the sum's own.
TP_SUMS = {"seconds": 0.0, "count": 0}


def time_tp_sums() -> None:
    """Route the layers' sums over tp through a wrapper that adds each one's count and time to TP_SUMS."""
    plain = tp._sum_over_tp

    def timed(x: torch.Tensor, group) -> torch.Tensor:
        sync = torch.cuda.synchronize if x.is_cuda else (lambda device: None)
        sync(x.device)
        t0 = time.perf_counter()
        y = plain(x, group)
        sync(x.device)
        TP_SUMS["seconds"] += time.perf_counter() - t0
        TP_SUMS["count"] += 1
        return y

    tp._sum_over_tp = timed


# The full-width pipeline check (82, on phase 81's four ranks): the calibrated Sepformer's first intra block, its 8
# layers over PP_STAGES stages of 2, PP_MICROBATCHES microbatches of the tokens it receives at TP_BATCH x 4 s (2 x 34
# chunks: 68 sequences of 250 tokens). JAX's rules (tests/test_pp.py:64, :84, :97).
PP_BLOCK = "masker.dp_0.intra_transformer_block"
PP_STAGES = PP_MICROBATCHES = 4
PP_SEED = 82  # the batch whose tokens the block receives
PP_FWD_TOL = 1e-5
PP_QAT_OF_MAX = 1e-2
PP_GRAD_ATOL, PP_GRAD_RTOL = 2e-4, 1e-4
# The kernels each pipeline call must launch (the counters of all_launches()).
PP_FLOAT_KERNELS = ("attention", "dense")
PP_PATH_KERNELS = {"float": PP_FLOAT_KERNELS, "qat": ("act", "weight", "attention", "dense"),
                   "grad": ("attention", "dense", "dense_mask", "dense_dx", "dense_dwq")}


def pp_inputs(dev, served: dict) -> dict:
    """Phase 82's inputs: the tokens that phase 25's calibrated Sepformer (``served``) feeds its first intra block's
    first layer at TP_BATCH x 4 s (a forward hook), and that block's layers' states and their spec."""
    qmodel = create_pretrained_model(SEPFORMER_CFG, observer=False)
    qmodel.load_state_dict(served)
    qmodel = qmodel.to(dev).eval()
    block = qmodel.get_submodule(PP_BLOCK)
    seen = []
    hook = block.layers[0].register_forward_pre_hook(lambda m, args: seen.append(args[0].detach().cpu().clone()))
    (mix, _), = tp_batches(PP_SEED, 1)
    with torch.inference_mode():
        qmodel(mix.to(dev))
    hook.remove()
    layer = block.layers[0]
    dims = (layer.mha.embed_dim, layer.ffn_in.weight.shape[0], layer.mha.num_heads)
    out = {"tokens": seen[0], "dims": dims, "q": dataclasses.asdict(qmodel.q),
           "states": [state_on_cpu(m) for m in block.layers]}
    del qmodel
    torch.cuda.empty_cache()
    return out


def pp_layers(dev, inputs: dict, name: str) -> list:
    """Phase 82's stack on ``dev``: the block's layers (``qat``), or float layers of the same weights (``float``)."""
    q = QuantSpec(**inputs["q"]) if name == "qat" else QuantSpec()
    layers = []
    for state in inputs["states"]:
        layer = TransformerLayer(*inputs["dims"], q=q)
        layer.load_state_dict({k: v for k, v in state.items() if k in layer.state_dict()})
        layers.append(layer.to(dev).eval())
    return layers


def pp_full_width(dev, world, inputs: dict) -> dict:
    """Phase 82 on this rank of a world of PP_STAGES: the float and QAT stacks' pipelined forwards and the float
    stack's gradient of sum(y^2) (this stage's, by the stack's layer index); each call's host-clock seconds (after a
    synchronize) and launches (from 0). The outputs on rank 0 only."""
    pmesh = pp.pipeline_mesh(world)
    x = inputs["tokens"].to(dev)
    out = {}
    for name in ("float", "qat", "grad"):
        stage = pp.shard_layer_stack(pp_layers(dev, inputs, "qat" if name == "qat" else "float"), pmesh)
        reset_all_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.set_grad_enabled(name == "grad"):
            y = pp.pipeline_layer_module(stage, x, pmesh, PP_MICROBATCHES)
            if name == "grad":
                y.square().sum().backward()
        torch.cuda.synchronize()
        out[f"{name}_s"], out[f"{name}_launches"] = time.perf_counter() - t0, all_launches()
        if name == "grad":
            n = len(stage)
            out["grads"] = {f"{stage.index * n + i}.{k}": p.grad.detach().cpu() for i, layer in enumerate(stage)
                            for k, p in layer.named_parameters() if p.grad is not None}
        elif world.rank == 0:
            out[name] = y.detach().cpu()
        del stage, y
    torch.cuda.empty_cache()
    return out


DRYRUN_PHASES = ("tp", "sp", "fsdp", "pp")


def dryrun_phases(dev, world) -> dict:
    """The port's dry run (fqss_tpu_torch/parallel/dryrun.py: ``run``, its four phases at the JAX function's sizes)
    on this rank of phase 81's world: each phase's launches (counted from 0 before it), rank 0 logging its lines."""
    lines, out = [], {}

    def mark(msg: str) -> None:  # the dry run calls it as each phase completes
        out[f"{DRYRUN_PHASES[len(lines)]}_launches"] = all_launches()
        lines.append(msg)
        reset_all_launches()

    reset_all_launches()
    final = dryrun.run(world, dev, mark)
    if world.rank == 0:
        log("\n".join([f"dry run: {line}" for line in lines] + [final]))
    return out


def tp_kd_steps(dev, cfg: dict, seed: int, batches: list, mesh=None, forced: list | None = None) -> dict:
    """KD steps of ``cfg``'s Sepformer and float teacher from ``seed`` on ``batches``; under ``mesh`` (a grid) the
    student sharded over its tp ranks and this rank's rows of each batch. Per step the whole learned parameters
    before it, the loss, the whole gradient after the step's reductions and clip, the host-clock seconds (after a
    synchronize) and the seconds of the gloo tp sums in it; the launches of the run (counted from 0).
    ``forced``: the whole learned parameters to take before each step (another run's; one process)."""
    model, teacher = create_model_and_teacher(cfg, generator=torch.Generator().manual_seed(seed))
    model, teacher = model.to(dev), teacher.to(dev)
    if mesh is not None:
        tp.shard_model_tp(model, mesh)
    state = new_train_state(model, teacher)
    step = make_train_step(TrainConfig(), mesh)
    out = {"before": [], "loss": [], "grads": [], "seconds": [], "tp_s": [], "tp_sums": []}
    reset_all_launches()
    for i, (mix, src) in enumerate(batches):
        if forced is not None:
            with torch.no_grad():
                for k, p in state.model.named_parameters():
                    if k in forced[i]:
                        p.copy_(forced[i][k])
        with dp.sharded(mesh):
            whole = shards.whole_state_dict(state.model) if mesh is not None else state_on_cpu(state.model)
        out["before"].append({k: whole[k] for k in learned_keys(state.model)})
        rows = mesh.rows(len(mix)) if mesh is not None else slice(None)
        TP_SUMS.update(seconds=0.0, count=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(state, mix[rows].to(dev), src[rows].to(dev))
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["tp_s"].append(TP_SUMS["seconds"])
        out["tp_sums"].append(TP_SUMS["count"])
        out["loss"].append(float(metrics["loss"]))
        with dp.sharded(mesh):
            grads = shards.whole_gradients(state.model)
        out["grads"].append(torch.cat([g.flatten().double() for g in grads.values()]))
    out["launches"] = all_launches()
    if not np.isfinite(out["loss"]).all() or state.skipped:
        raise AssertionError(f"KD steps: losses {out['loss']}, skipped {state.skipped}")
    del state, model, teacher
    torch.cuda.empty_cache()
    return out


def tp_forwards(dev, served: dict, x: torch.Tensor, mesh=None) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Phase 80's forwards of ``x``: the float Sepformer from seed 80 and the calibrated QAT one (``served``, phase
    25's state), each sharded over ``mesh``'s tp ranks where given; with the launches of the QAT forward."""
    _, fmodel = create_model_and_teacher(TP_CFG, generator=torch.Generator().manual_seed(80))
    qmodel = create_pretrained_model(SEPFORMER_CFG, observer=False)
    qmodel.load_state_dict(served)
    outs = []
    for model in (fmodel, qmodel):
        model = model.to(dev).eval()
        if mesh is not None:
            tp.shard_model_tp(model, mesh)
        reset_all_launches()
        with torch.inference_mode(), dp.sharded(mesh):
            outs.append(model(x.to(dev)).cpu())
        del model
    torch.cuda.empty_cache()
    return outs[0], outs[1], all_launches()


def tp_batches(seed: int, steps: int) -> list:
    return ddp_batches(TP_BATCH, TP_SEG, steps, seed)


def tp_worker(out_dir: str, dev: torch.device | None = None) -> None:
    """A rank of phase 80 (a world of TP_SIZE: the grid's dp 1) or 81 (a world of 2 x TP_SIZE) (``python3
    chip_smoke.py --tp-worker DIR`` with torchrun's variables): gloo on cuda:0; what it saw goes to DIR/rank<r>.pt
    (the learned parameters and gradients on rank 0 only)."""
    if dev is None:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
        dev = torch.device("cuda", 0)
    infer.disable_tf32()
    torch.backends.cudnn.deterministic = True  # as the one-process runs it is held to (deterministic_cudnn)
    world = dp.init_distributed(dev, backend="gloo")
    try:
        mesh = dp.grid(world, TP_SIZE)
        time_tp_sums()
        _build.library()
        log(f"rank {world.rank} (dp {mesh.rank} of {mesh.size}, tp {mesh.tp_rank} of {mesh.tp_size}): in the group "
            f"after {time.perf_counter() - _CLOCK['start']:.1f} s")
        result = {}
        if mesh.size == 1:
            inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=True)
            result["float"], result["qat"], result["forward_launches"] = tp_forwards(dev, inputs["served"],
                                                                                     inputs["x"], mesh)
            result["steps"] = tp_kd_steps(dev, TP_CFG, 80, tp_batches(80, TP_STEPS), mesh)
        else:  # 81, the dry run's phase 1; its phases 2-4 and the full-width pipeline (82) on the same ranks
            result["steps"] = tp_kd_steps(dev, TP_GRID_CFG, 81, tp_batches(81, 1), mesh)
            clock(f"81 on rank {world.rank}")
            result["dryrun"] = dryrun_phases(dev, world)
            clock(f"the dry run on rank {world.rank}")
            result["pp"] = pp_full_width(dev, world, torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=True))
        clock(f"{80 if mesh.size == 1 else 82} on rank {world.rank}")
        if world.rank:
            del result["steps"]["before"], result["steps"]["grads"]
        torch.save(result, os.path.join(out_dir, f"rank{world.rank}.pt"))
    finally:
        dp.shutdown()


def spawn_ranks(flag: str, world: int, tmp: str, label: str) -> list[dict]:
    """``world`` ranks of this script with ``flag`` sharing cuda:0 over gloo (``parallel.mesh.spawn``), rank 0's
    output logged under ``label``; each rank's DIR/rank<r>.pt."""
    try:
        outs = dp.spawn([*DDP_WORKER, flag, tmp], world, timeout=600)
    except RuntimeError as e:
        raise AssertionError(f"{label}: {e}") from None
    log("\n".join(f"[{label}]   {line}" for line in outs[0].splitlines()))
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True) for r in range(world)]


def tp_share(got: dict) -> str:
    """The share of each of ``got``'s steps (tp_kd_steps on a grid) spent in the gloo tp sums."""
    return ", ".join(f"{100 * s / t:.1f}%" for s, t in zip(got["tp_s"], got["seconds"]))


def tp_step_rule(phase: int, label: str, got: dict, want: dict, ranks: int, smi: str) -> None:
    """Each step's loss within TP_LOSS_DB and whole-gradient cosine at least TP_GRAD_COS of one process's (from the
    ranks' learned parameters); raises after the log line where a step misses."""
    dloss = [abs(g - w) for g, w in zip(got["loss"], want["loss"])]
    cos = [float(g @ w / (g.norm() * w.norm())) for g, w in zip(got["grads"], want["grads"])]
    rel = [float((g - w).norm() / w.norm()) for g, w in zip(got["grads"], want["grads"])]
    share = [f"{100 * s / t:.1f}% ({n} sums, {1e3 * s:.1f} ms)" for s, t, n in zip(got["tp_s"], got["seconds"],
                                                                                    got["tp_sums"])]
    log(f"[{phase}] {label}, {ranks} ranks sharing one card over gloo against one process: loss |diff| "
        f"{[f'{v:.2e}' for v in dloss]} dB (<= {TP_LOSS_DB}), whole-gradient cosine {[f'{v:.7f}' for v in cos]} "
        f"(>= {TP_GRAD_COS}), relative L2 {[f'{v:.2e}' for v in rel]}; step "
        f"{[round(1e3 * v, 1) for v in got['seconds']]} ms on the ranks, of it the gloo tp sums {share} (through the "
        f"host: not a speed finding); one process {[round(1e3 * v, 1) for v in want['seconds']]} ms, on {smi}")
    if max(dloss) > TP_LOSS_DB or min(cos) < TP_GRAD_COS:
        raise AssertionError(f"phase {phase}'s rule: loss |diff| {dloss}, cosine {cos}")


def tensor_parallel(dev, smi: str, served: dict) -> dict:
    """Phases 80-82: the Sepformer sharded over gloo ranks on cuda:0 against one process. ``served``: phase 25's
    calibrated state. Phase 80's two ranks and phase 81's four run side by side, each spawn its own process group on
    the one card (their step times are not speed findings). Returns each path's launches (the ranks', summed)."""
    (x, _), = tp_batches(79, 1)
    inputs = pp_inputs(dev, served)
    spawned = {}
    with tempfile.TemporaryDirectory() as tmp80, tempfile.TemporaryDirectory() as tmp81:
        torch.save({"served": served, "x": x}, os.path.join(tmp80, "inputs.pt"))
        torch.save(inputs, os.path.join(tmp81, "inputs.pt"))
        side_by_side(lambda: spawned.update(ranks=spawn_ranks("--tp-worker", TP_SIZE, tmp80, "80")),
                     lambda: spawned.update(grid=spawn_ranks("--tp-worker", 2 * TP_SIZE, tmp81, "81")))
    ranks, grid = spawned["ranks"], spawned["grid"]
    clock("the ranks of 80 and of 81-82, side by side")
    # 80. the forwards against one process holding the whole weights, then the steps from the ranks' parameters
    y_float, y_qat, one_launches = tp_forwards(dev, served, x)
    snr_f = [snr_db(y_float, r["float"]) for r in ranks]
    snr_q = [snr_db(y_qat, r["qat"]) for r in ranks]
    log(f"[80] Sepformer (E 256, 8 heads, FFN 1024, 2 x 8 + 8 layers) sharded over {TP_SIZE} tp ranks sharing one "
        f"card over gloo (each rank's {tuple(x.shape)} forward) against one process holding the whole weights: "
        f"float SNR {[[round(v, 2) for v in t.flatten().tolist()] for t in snr_f]} dB (>= {TP_FLOAT_DB}), "
        f"calibrated QAT (phase 25's ranges) SNR {[[round(v, 2) for v in t.flatten().tolist()] for t in snr_q]} dB "
        f"(> {TP_QAT_DB}); launches of a rank's QAT forward "
        f"{', '.join(f'{k}={v}' for k, v in ranks[0]['forward_launches'].items() if v)}")
    if not all(bool((t >= TP_FLOAT_DB).all()) for t in snr_f) or not all(bool((t > TP_QAT_DB).all()) for t in snr_q):
        raise AssertionError(f"phase 80's forward rules: float {snr_f}, QAT {snr_q}")
    with deterministic_cudnn():
        one = tp_kd_steps(dev, TP_CFG, 80, tp_batches(80, TP_STEPS), forced=ranks[0]["steps"]["before"])
    tp_step_rule(80, f"{TP_STEPS} KD steps of {TP_BATCH} x {TP_SEG // SR} s through the observer window", ranks[0]["steps"],
                 one, TP_SIZE, smi)
    clock(f"80 (the gloo tp sums {tp_share(ranks[0]['steps'])} of its steps on rank 0)")
    # 81. dp 2 x tp 2 (the dry run's phase 1 at full width), then the dry run and 82 on the same four ranks
    with deterministic_cudnn():
        one81 = tp_kd_steps(dev, TP_GRID_CFG, 81, tp_batches(81, 1), forced=grid[0]["steps"]["before"])
    tp_step_rule(81, f"dp 2 x tp 2, the Sepformer at one layer a block, a KD step of {TP_BATCH} x {TP_SEG // SR} s "
                 f"(one row a dp rank)", grid[0]["steps"], one81, 2 * TP_SIZE, smi)
    sums = lambda runs: {k: sum(run[k] for run in runs) for k in runs[0]}  # noqa: E731
    paths = {"80 forwards": sums([r["forward_launches"] for r in ranks]),
             "80 steps": sums([r["steps"]["launches"] for r in ranks]),
             "81": sums([r["steps"]["launches"] for r in grid]),
             "81 dry run": sums([r["dryrun"]["tp_launches"] for r in grid])}
    for path in ("80 steps", "81", "81 dry run"):
        idle = [k for k in TP_PATH_KERNELS if not paths[path][k]]
        if idle:
            raise AssertionError(f"the tensor-parallel path {path} launched no {idle}: {paths[path]}")
    log(f"[80-81] launches on the ranks (summed), counted from 0 before each path: "
        + "; ".join(f"{path} {', '.join(f'{k}={v}' for k, v in c.items() if v)}" for path, c in paths.items()))
    clock(f"81 (the gloo tp sums {tp_share(grid[0]['steps'])} of its step on rank 0)")
    return {"tp": paths, **pipeline_checks(dev, smi, grid, inputs)}


def pipeline_checks(dev, smi: str, grid: list[dict], inputs: dict) -> dict:
    """The dry run's launches on phase 81's ranks and phase 82: the four ranks' pipelined calls against the stack in
    order in this process, by JAX's rules. Returns the launches of the data-parallel, FSDP and pipeline paths (the
    ranks', summed)."""
    sums = lambda runs: {k: sum(run[k] for run in runs) for k in runs[0]}  # noqa: E731
    x = inputs["tokens"].to(dev)
    # the witness: the same stack on the same tokens with the microbatches in reverse order, the same function (the
    # gradient of a sum over rows), its sums over the rows taken in another order
    reversed_x = x.reshape(PP_MICROBATCHES, -1, *x.shape[1:]).flip(0).reshape(x.shape)
    want, seconds = {}, {}
    for name in ("float", "qat", "grad", "witness"):
        layers = pp_layers(dev, inputs, "qat" if name == "qat" else "float")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.set_grad_enabled(name in ("grad", "witness")):
            y = sequential_stack(layers, reversed_x if name == "witness" else x)
            if name in ("grad", "witness"):
                y.square().sum().backward()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        want[name] = ({f"{i}.{k}": p.grad.detach().cpu() for i, layer in enumerate(layers)
                       for k, p in layer.named_parameters() if p.grad is not None} if name in ("grad", "witness")
                      else y.detach().cpu())
        del layers, y
    # the second witness: the stack in order on each microbatch alone, the gradients summed as the pipeline's
    # backward sums them (the last microbatch's first)
    layers = pp_layers(dev, inputs, "float")
    for mb in reversed(x.reshape(PP_MICROBATCHES, -1, *x.shape[1:]).unbind(0)):
        sequential_stack(layers, mb).square().sum().backward()
    split = {f"{i}.{k}": p.grad.detach().cpu() for i, layer in enumerate(layers) for k, p in layer.named_parameters()
             if p.grad is not None}
    del layers
    torch.cuda.empty_cache()
    got = grid[0]["pp"]
    grads = {k: g for r in grid for k, g in r["pp"]["grads"].items()}
    fwd_err = float(((got["float"] - want["float"]).abs() - PP_FWD_TOL * want["float"].abs()).max())
    qat_err = float((got["qat"] - want["qat"]).abs().max())
    qat_max = float(want["qat"].abs().max())
    over = lambda got: {k: float(((g - want["grad"][k]).abs() - PP_GRAD_RTOL * want["grad"][k].abs()).max())  # noqa: E731
                        for k, g in got.items()}
    grad_over, own_over = over(grads), over(want["witness"])
    split_equal = sum(torch.equal(g, split[k]) for k, g in grads.items() if k in split)
    grad_fail = [k for k, v in grad_over.items() if v > PP_GRAD_ATOL]
    worst, own_worst = max(grad_over, key=grad_over.get), max(own_over, key=own_over.get)
    rank_s = lambda key: max(r["pp"][key] for r in grid)  # noqa: E731
    n = len(inputs["states"])
    log(f"[82] the calibrated Sepformer's first intra block (its float weights, and QAT; {n} layers, E {inputs['dims'][0]}, {inputs['dims'][2]} "
        f"heads, FFN {inputs['dims'][1]}) over {PP_STAGES} pipeline stages of {n // PP_STAGES} layers on four ranks sharing one card "
        f"over gloo, {PP_MICROBATCHES} microbatches of the {tuple(inputs['tokens'].shape)} tokens it receives at "
        f"{TP_BATCH} x {TP_SEG // SR} s ({inputs['tokens'].shape[0] // PP_MICROBATCHES} sequences each), against the "
        f"layers in order in one process: float forward max |diff| minus {PP_FWD_TOL} x |y| {fwd_err:.3g} (<= "
        f"{PP_FWD_TOL}), bitwise {torch.equal(got['float'], want['float'])}; QAT forward (phase 25's ranges) max |diff| "
        f"{qat_err:.3g} against {PP_QAT_OF_MAX} x max|y| = {PP_QAT_OF_MAX * qat_max:.3g}, bitwise "
        f"{torch.equal(got['qat'], want['qat'])}; float gradient of sum(y^2): {len(grads)} tensors, the worst "
        f"|diff| - {PP_GRAD_RTOL} x |g| {grad_over[worst]:.3g} at {worst} (<= {PP_GRAD_ATOL}), bitwise "
        f"{sum(torch.equal(g, want['grad'][k]) for k, g in grads.items())} of {len(grads)}, {len(grad_fail)} tensors "
        f"over the rule (the witness, the stack in order on the microbatches in reverse order: the worst "
        f"{own_over[own_worst]:.3g} at {own_worst}, {sum(v > PP_GRAD_ATOL for v in own_over.values())} tensors over "
        f"it; the stack on each microbatch alone, its gradients summed as the pipeline sums them: bitwise "
        f"{split_equal} of {len(grads)} (must be all), max |diff| "
        f"{max(float((g - split[k]).abs().max()) for k, g in grads.items() if k in split):.3g}); calls on the ranks "
        f"{1e3 * rank_s('float_s'):.1f} / {1e3 * rank_s('qat_s'):.1f} / {1e3 * rank_s('grad_s'):.1f} ms (float, QAT, "
        f"gradient; host clock through gloo: not a speed finding), in one process {1e3 * seconds['float']:.1f} / "
        f"{1e3 * seconds['qat']:.1f} / {1e3 * seconds['grad']:.1f} ms, on {smi}")
    if (fwd_err > PP_FWD_TOL or qat_err > PP_QAT_OF_MAX * qat_max + 1e-6 or grads.keys() != want["grad"].keys()
            or grads.keys() != split.keys() or split_equal != len(grads)):
        raise AssertionError(f"phase 82's rules: float {fwd_err}, QAT {qat_err} of {qat_max}, the gradients bitwise "
                             f"the stack on each microbatch alone: {split_equal} of {len(grads)}")
    if grad_fail:  # JAX's rule sits below the card's own floor here (the first witness): ROADMAP queue 3
        standing(f"phase 82's gradient against the stack in order by JAX's rule: {len(grad_fail)} of {len(grads)} "
                 f"tensors over {PP_GRAD_ATOL} absolute + {PP_GRAD_RTOL} relative, {grad_fail[:5]}, the worst "
                 f"{grad_over[worst]:.3g}; the same stack with its microbatches reversed puts "
                 f"{sum(v > PP_GRAD_ATOL for v in own_over.values())} over it (the worst {own_over[own_worst]:.3g})")
    paths = {"sp": sums([r["dryrun"]["sp_launches"] for r in grid]),
             "fsdp": sums([r["dryrun"]["fsdp_launches"] for r in grid]),
             "pp": {**{f"82 {name}": sums([r["pp"][f"{name}_launches"] for r in grid]) for name in PP_PATH_KERNELS},
                    "81 dry run": sums([r["dryrun"]["pp_launches"] for r in grid])}}
    for name, kernels in PP_PATH_KERNELS.items():
        idle = [k for k in kernels if not paths["pp"][f"82 {name}"][k]]
        if idle:
            raise AssertionError(f"the pipeline's {name} call launched no {idle}: {paths['pp'][f'82 {name}']}")
    idle = [k for k in DDP_PATH_KERNELS["fsdp"] if not paths["fsdp"][k]]
    if idle:
        raise AssertionError(f"the dry run's FSDP step launched no {idle}: {paths['fsdp']}")
    log(f"[81-82] launches on the ranks (summed), counted from 0 before each path: the dry run's sp "
        + ", ".join(f"{k}={v}" for k, v in paths["sp"].items() if v) + "; its fsdp "
        + ", ".join(f"{k}={v}" for k, v in paths["fsdp"].items() if v) + "; "
        + "; ".join(f"{path} {', '.join(f'{k}={v}' for k, v in c.items() if v)}" for path, c in paths["pp"].items()))
    return paths


def main() -> None:
    _CLOCK["start"] = _CLOCK["last"] = time.perf_counter()
    # 0. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the GPU only")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    infer.disable_tf32()
    log(f"[0] device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)

    # 1. build
    built = _build.build()
    _build.library()
    log(f"[1] build: {'compiled' if built.compiled else 'found'} {built.path.name} in {built.seconds:.2f} s")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[1]   {line.strip()}")
    dense_kernel_report(built.log)
    lstm_int8_kernel_report(built.log)
    attention_kernel_report(built.log)

    clock("0-1")

    # 2. kernels vs plain versions on the card
    act = check_act_kernel(dev)
    weight_per_tensor = check_weight_kernel(dev)
    groups, group_pairs = check_weight_groups(dev)
    torch.cuda.empty_cache()

    # 3. the full-width model on the card
    mix, _ = synth_batch(np.random.default_rng(0), BATCH, 2, SEG)
    served = build_served_model(dev, mix[:4])
    n_act = sum(isinstance(m, ActQuantizer) for m in served.modules())
    n_weight = sum(isinstance(m, WeightQuantizer) for m in served.modules())
    n_params = sum(p.numel() for n, p in served.named_parameters() if "fake_quantize" not in n)
    x = torch.from_numpy(mix).to(dev)
    fq.reset_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        y = served(x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(fq.LAUNCHES)
    if tuple(y.shape) != (BATCH, 2, SEG) or not torch.isfinite(y).all():
        raise AssertionError(f"forward gave shape {tuple(y.shape)}, finite={bool(torch.isfinite(y).all())}")
    if launches != {"act": n_act, "weight": 1, "act_bwd": 0, "weight_bwd": 0}:
        raise AssertionError(f"launches {launches} != act quantizer modules ({n_act}) and one grouped weight launch")
    log(f"[3] full-width forward {tuple(x.shape)} -> {tuple(y.shape)}, finite, {n_params} parameters, "
        f"first call {first_s:.2f} s; launches act={launches['act']} (= act quantizer modules) "
        f"weight={launches['weight']} (the {n_weight} weight quantizers in one grouped launch)")

    # 4. card vs CPU on the same weights
    cpu_model = ConvTasNet(n_srcs=2, kernel_size=16, stride=8, q=SPEC)
    cpu_model.load_state_dict(served.state_dict())
    cpu_model.eval()
    x1 = torch.from_numpy(mix[:1, :SR])
    with torch.inference_mode():
        y_card = served(x1.to(dev)).cpu()
        y_cpu = cpu_model(x1)
    snr = snr_db(y_cpu, y_card)
    if not bool((snr >= 20).all()):
        raise AssertionError(f"card vs CPU SNR {snr.tolist()} dB < 20 dB")
    fq_floor = (snr.min().item(), (y_card - y_cpu).abs().mean().item() / out_step(served))
    log(f"[4] card vs CPU at 1 x {SR}: SNR {[round(v, 2) for v in snr.flatten().tolist()]} dB (>= 20), "
        f"{(y_card != y_cpu).float().mean().item():.4f} of samples differ, mean {fq_floor[1]:.4f} output steps")

    # 5. folded engine
    folded = fold_quantized_weights(served)
    before = dict(fq.LAUNCHES)
    with torch.inference_mode():
        y_folded = folded(x)
    torch.cuda.synchronize()
    if fq.LAUNCHES["weight"] != before["weight"]:
        raise AssertionError("the folded forward launched the weight kernel")
    if not torch.equal(y_folded, y):
        raise AssertionError(f"folded != fake-quant, max abs diff {(y_folded - y).abs().max().item()}")
    log(f"[5] folded engine: bitwise equal to fake-quant; act launches +{fq.LAUNCHES['act'] - before['act']}, "
        "weight launches +0")

    # 6. a few requests through the infer entry
    latencies = serve_requests(dev, served.state_dict(), MODEL_CFG)
    for i, s in enumerate(latencies):
        log(f"[6] request {i}: 20 s mixture -> 2 sources of 20 s, {s * 1000:.1f} ms")

    # 7. throughput of both engines
    audio_s = BATCH * SEG / SR
    for name, model in (("fake_quant", served), ("folded", folded)):
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(x), 3)
        log(f"[7] throughput {name}: {audio_s / (ms / 1000):.1f} sec-audio/s ({ms:.1f} ms per forward of "
            f"{BATCH} x {SEG // SR} s) on {smi}")
    del folded, model, y_folded
    torch.cuda.empty_cache()

    # 8. backward kernels vs plain versions on the card
    act_bwd = check_act_bwd_kernel(dev)
    weight_bwd_per_tensor = check_weight_bwd_kernel(dev)
    group_bwd = check_weight_group_bwd(dev, group_pairs)
    del group_pairs
    torch.cuda.empty_cache()

    # 9. KD training at full width (launch counts set to 0 inside, read after the last step)
    state, train_launches = train_at_full_width(dev)

    # 10. card vs CPU on one train step
    card_vs_cpu_step(dev, state)

    # 11. train-step time
    train_step_time(dev, state, smi)
    del state
    torch.cuda.empty_cache()

    # 12. the int8 kernel vs its plain version on the card
    int8 = check_int8_kernel(dev)

    # 13. the int8 engine at full width (launch counts set to 0 inside, read after each forward)
    engines, int8_launches = int8_engine_at_full_width(dev, served, x, y, fq_floor)

    int8_engine_with_trained_residual_decoder(dev, mix)
    torch.cuda.empty_cache()

    # 14. requests through the infer entry with the int8 engine
    for i, s in enumerate(serve_requests(dev, served.state_dict(), MODEL_CFG, "int8")):
        log(f"[14] request {i} (int8 engine): 20 s mixture -> 2 sources of 20 s, {s * 1000:.1f} ms")

    # 15. throughput of the int8 engine
    for dtype, engine in engines.items():
        ms = cuda_ms(lambda: engine(x), 3)
        log(f"[15] throughput int8 ({dtype} float convs): {audio_s / (ms / 1000):.1f} sec-audio/s ({ms:.1f} ms per "
            f"forward of {BATCH} x {SEG // SR} s) on {smi}")
    del engines
    torch.cuda.empty_cache()

    # 16. evaluation of two engines on a LibriMix-layout folder
    evaluate_engines(dev, served)
    states = {"ConvTasNet": state_on_cpu(served)}
    del served, x, y
    torch.cuda.empty_cache()

    clock("2-16")

    # 17-23. the DPTNet serving path (launch counts set to 0 inside before each run they check)
    k6, k7, dpt_launches, dpt_attn_shapes, dpt_k3_shapes, states["DPTNet"], dpt_k4 = serve_dptnet(dev, smi)
    torch.cuda.empty_cache()

    clock("17-23")

    # 24-30. K8 and the Sepformer serving path (launch counts set to 0 inside before each run they check)
    attn, sep_launches, sep_k3_shapes, states["Sepformer"], sep_k4 = serve_sepformer(dev, smi, dpt_attn_shapes)
    torch.cuda.empty_cache()

    clock("24-30")

    # 31-36. K5, K5-bwd, the LSTM backward and DPTNet and Sepformer training (launch counts set to 0 inside)
    dense_fwd, dense_bwd, train_model_launches = train_models(dev, smi)
    torch.cuda.empty_cache()


    # 37-39. K3 at the shapes of phases 18 and 25, streaming and --engine auto (launch counts set to 0 inside)
    qmm = k3_slice(dev, smi, [*dpt_k3_shapes, *sep_k3_shapes], states)
    torch.cuda.empty_cache()

    clock("37-39")

    # 40-42. bf16 compute on the three models' serving path (launch counts set to 0 inside before each forward)
    k5_shapes, k3_shapes, attn_shapes, bf16_launches = serve_bf16(dev, smi, states)
    bf16_count = {k: sum(run[k] for run in bf16_launches) for k in ("dense_bf16", "qmatmul_bf16", "attention_bf16")}
    torch.cuda.empty_cache()
    # 43. the bf16 routes of K5, K3 and K8 against their plain versions at those forwards' shapes
    dense16, qmm16 = check_bf16_dense(dev, k5_shapes, k3_shapes)
    attn16 = check_bf16_attention(dev, attn_shapes)
    torch.cuda.empty_cache()

    # 44-52. the ConvTasNet-music slice (launch counts set to 0 inside before each run they check)
    clock("40-43")
    music = serve_music(dev, smi)
    music_k3, music_k4, music_train = music["qmm"], music["k4"], music["train"]
    states["ConvTasNetMusic"] = music["state"]
    torch.cuda.empty_cache()

    # 54-60. the HTDemucs serving slice (launch counts set to 0 inside before each run they check)
    htd = serve_htdemucs(dev, smi)
    htd_launches, htd_attn, htd_attn16 = htd["launches"], htd["attn"], htd["attn16"]
    states["HTDemucs"] = htd["state"]
    torch.cuda.empty_cache()
    clock("54-60")

    # 61-64. the HTDemucs training slice (launch counts set to 0 inside before each run they check)
    htd_train = htdemucs_training(dev, smi)  # 61-63.
    htd_train_launches = htd_train["launches"]
    clock("61-63")
    side_by_side(music_recipe_epoch, htdemucs_recipe_epoch)  # 53 and 64, the two recipes' processes side by side
    clock("53, 64")

    # 65-68. checkpoint import (launch counts set to 0 inside before each forward and step they check)
    imported = checkpoint_import(dev, states)
    clock("65-68")

    # 69-71. the reference's other quantizers (launch counts set to 0 inside before each run they check)
    variants = quant_variants(dev, smi)

    # 72-74. the LSTM's static and dynamic modes (launch counts set to 0 inside before each run they check)
    modes = lstm_modes(dev, smi, states["DPTNet"])

    # 75-78. data parallelism: two ranks on the card over gloo, a one-rank NCCL group (launch counts set to 0 before
    # each path, on each rank)
    ddp = data_parallel(dev, smi)
    clock("75, 77-79")

    # 80-82. tensor parallelism: the Sepformer over tp 2 and dp 2 x tp 2 grids of gloo ranks on the card, then on the
    # same four ranks the dry run's phases 2-4 and the full-width pipeline (launch counts set to 0 before each path,
    # on each rank)
    tensor = tensor_parallel(dev, smi, states["Sepformer"])
    clock("80-82")

    def bf16_keys(res: dict, launches: int, route: str) -> dict:
        """A kernel's bf16 route in the kernels line: its time, bound, plain time and library time per forward (the
        phase 43 sums), its launches in phases 40-42's forwards."""
        return dict(bf16_route_detail=route, bf16_launches=launches, bf16_ms=res["ms"], bf16_bound_ms=res["bound_ms"],
                    bf16_plain_ms=res["plain_ms"], bf16_f32_route_ms=res["f32_ms"],
                    bf16_library_ms=res.get("library_ms"), bf16_max_abs_err=res["max_abs_err"])

    source = "fqss_tpu_torch/csrc/fake_quant.cu"
    elementwise = "CUDA cores, elementwise"
    kernels = [
        dict(name="act_fake_quant", route="cuda", route_detail=elementwise, source=source,
             replaces="fqss_tpu/ops/pallas_qat.py:87",
             launches=launches["act"], library_ms=None, **act, music_launches=music["launches"]["act"],
             htdemucs_launches=htd_launches["act"], htdemucs_int8_launches=htd["int8_launches"]["act"]),
        # ms, plain_ms, bound_ms: the grouped launch of the ConvTasNet's 101 weight quantizers (phase 2, eval);
        # dptnet_*, sepformer_*: the other two models' full weight sets; per_tensor_ms: the per-tensor kernel that
        # the fold and a layer outside a model's pass take, at [1024, 128, 1]. launches: phase 3's forward.
        dict(name="weight_fake_quant", route="cuda", route_detail=GROUP_ROUTE, source=source,
             replaces="fqss_tpu/ops/pallas_qat.py:204", launches=launches["weight"], library_ms=None,
             **groups["ConvTasNet"], **{f"{m.lower()}_{k}": groups[m][k]
                                        for m in ("DPTNet", "Sepformer", "ConvTasNetMusic", "HTDemucs")
                                        for k in ("ms", "bound_ms")},
             per_tensor_ms=weight_per_tensor["ms"],
             music_launches=music["launches"]["weight"], htdemucs_launches=htd_launches["weight"]),
        dict(name="act_fake_quant_bwd", route="cuda", route_detail=elementwise, source=source,
             replaces="fqss_tpu/ops/pallas_qat.py:95",
             launches=train_launches["act_bwd"], library_ms=None, **act_bwd,
             music_launches=music_train["launches"]["act_bwd"], htdemucs_launches=htd_train_launches["act_bwd"]),
        # The grouped backward of the same sets (phase 8); launches: phase 9's 8 train steps.
        dict(name="weight_fake_quant_bwd", route="cuda", route_detail=GROUP_ROUTE, source=source,
             replaces="fqss_tpu/ops/pallas_qat.py:214", launches=train_launches["weight_bwd"], library_ms=None,
             **group_bwd["ConvTasNet"], **{f"{m.lower()}_{k}": group_bwd[m][k]
                                           for m in ("DPTNet", "Sepformer", "ConvTasNetMusic", "HTDemucs")
                                           for k in ("ms", "bound_ms")},
             per_tensor_ms=weight_bwd_per_tensor["ms"], music_launches=music_train["launches"]["weight_bwd"],
             htdemucs_launches=htd_train_launches["weight_bwd"]),
        # ms, plain_ms, bound_ms: one ConvTasNet forward's 74 launches; int_mm_ms: torch._int_mm, the product alone
        # (int32 out, no epilogue), so no library call computes this function: library_ms is null. dptnet_*,
        # sepformer_*: one DPTNet and one Sepformer int8 forward's launches (phases 22 and 29).
        dict(name="int8_matmul_requant", route="cuda", route_detail=INT8_ROUTE,
             source="fqss_tpu_torch/csrc/int8_matmul.cu",
             replaces="fqss_tpu/ops/pallas_quant.py:168", launches=int8_launches, library_ms=None, **int8,
             dptnet_ms=dpt_k4["ms"], dptnet_bound_ms=dpt_k4["bound_ms"], dptnet_launches=dpt_k4["launches"],
             sepformer_ms=sep_k4["ms"], sepformer_bound_ms=sep_k4["bound_ms"], sepformer_launches=sep_k4["launches"],
             music_ms=music_k4["ms"], music_bound_ms=music_k4["bound_ms"], music_launches=music["k4_launches"],
             **{f"htdemucs_{k}": htd["k4"][k] for k in ("ms", "plain_ms", "bound_ms", "launches", "int_mm_ms")}),
        # K4's GELU epilogue (nl 3): ms, plain_ms, bound_ms: one HTDemucs int8 forward's 10 launches (every linear1,
        # phase 59); launches: phase 57's float32 engine forward. int_mm_ms: torch._int_mm, the product alone, so no
        # library call computes this function: library_ms is null.
        dict(name="int8_matmul_requant_gelu", route="cuda", route_detail=INT8_ROUTE + "; the exact GELU (erfcf) "
             "between the dequantization and the requantization", source="fqss_tpu_torch/csrc/int8_matmul.cu",
             replaces="fqss_tpu/ops/pallas_quant.py:168", launches=htd["gelu_launches"], library_ms=None,
             **{k: htd["k4_gelu"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "int_mm_ms", "max_abs_err")}),
        # ms, plain_ms, bound_ms, library_ms: one DPTNet forward's 12 launches (6 at the row shape, 6 at the
        # column shape); library_ms: cuDNN's bidirectional nn.LSTM on the same weights and input, its own input
        # projection included. launches: phase 18's forward.
        dict(name="bilstm_sequence", route="cuda", route_detail=LSTM_ROUTE,
             source="fqss_tpu_torch/csrc/lstm.cu",
             replaces="fqss_tpu/ops/pallas_lstm.py:114", launches=dpt_launches["bilstm"], **k7),
        # One direction at the row shape, per launch. DPTNet's LSTMs are bidirectional, so K6 is not launched
        # on its path (launches 0 in phase 18's forward; phase 17 checks and times it).
        dict(name="lstm_sequence", route="cuda", route_detail=LSTM_ROUTE,
             source="fqss_tpu_torch/csrc/lstm.cu",
             replaces="fqss_tpu/ops/pallas_lstm.py:54", launches=dpt_launches["lstm"], **k6),
        # The static route of K7 (QLSTM(mode="static")): ms, plain_ms, bound_ms: one static DPTNet forward's 12
        # launches with the window closed (phase 72); fused_ms: K7's fused route on the same inputs; window_ms: the
        # same forward with every call inside the observer window (two launches and the EMA a call); no library call
        # computes the quantized cell (library_ms null). launches: phase 73's serving forward. JAX runs this cell as a
        # lax.scan (jax_static_cell), so it replaces K7's Pallas kernel on that path.
        dict(name="bilstm_static_sequence", route="cuda", route_detail=LSTM_ROUTE + "; the 12 sites' grids in shared "
             "memory, each value on K1's device functions; the observer window a launch of its own (kObserve)",
             source="fqss_tpu_torch/csrc/lstm_static.cu", replaces="fqss_tpu/ops/pallas_lstm.py:114",
             jax_static_cell="fqss_tpu/nn/lstm.py:108-176", launches=modes["serve"]["bilstm_static"],
             **{k: modes["k7"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
                                             "fused_ms", "window_ms")},
             train_launches=modes["train"]["bilstm_static"], int8_launches=modes["int8"]["bilstm_static"]),
        # One direction at the row shape, per launch (phase 72); DPTNet's LSTMs are bidirectional (launches 0).
        dict(name="lstm_static_sequence", route="cuda", route_detail=LSTM_ROUTE,
             source="fqss_tpu_torch/csrc/lstm_static.cu", replaces="fqss_tpu/ops/pallas_lstm.py:54",
             launches=modes["serve"]["lstm_static"], **modes["k6"]),
        # ms, plain_ms, bound_ms, library_ms: one Sepformer forward's 32 launches (16 intra-chunk, 16 inter-chunk)
        # through the packed entry, as the module calls it; library_ms: F.scaled_dot_product_attention, then K1 for
        # the head grid; route_bound_ms: Q K^T at the float32 peak beside P V as 3 TF32 products a float32 one at
        # the TF32 peak (attention_route_bound). launches: phase 25's
        # forward. dptnet_*: one DPTNet forward's 12 launches (6 row, 6 column; phase 18 counts them).
        # bf16_*: the bf16 route (phase 43) per Sepformer bf16 forward (32 launches; bf16_dptnet_*: per DPTNet bf16
        # forward), bf16_launches: phases 41-42's forwards; no library call computes it (SDPA in bf16 neither
        # rounds the normalised softmax nor returns float32 heads): bf16_library_ms null.
        dict(name="fused_attention", route="cuda", route_detail=ATTN_ROUTE, source="fqss_tpu_torch/csrc/attention.cu",
             replaces="fqss_tpu/ops/pallas_attention.py:83", launches=sep_launches["attention"], **attn,
             **bf16_keys(attn16, bf16_count["attention_bf16"], BF16_ATTN_ROUTE),
             **{f"bf16_dptnet_{k}": attn16[f"dptnet_{k}"] for k in ("ms", "f32_ms", "plain_ms", "bound_ms",
                                                                    "launches")},
             # htdemucs_*: one HTDemucs forward's 10 launches (6 self, 4 cross; d 48 on the D 64 instantiation) at
             # 8 x 441,000 (phase 59); bf16_htdemucs_*: its bf16 route, which the bf16 int8 engine runs.
             htdemucs_launches=htd_launches["attention"],
             **{f"htdemucs_{k}": htd_attn[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "route_bound_ms",
                                                       "max_abs_err")},
             **{f"bf16_htdemucs_{k}": htd_attn16[k] for k in ("ms", "f32_ms", "plain_ms", "bound_ms", "launches",
                                                              "max_abs_err")}),
        # ms, plain_ms, bound_ms, library_ms: one DPTNet and one Sepformer student forward's 166 K5 launches at the
        # training batch (phase 31): the 78 QDense layers (library_ms: torch.addmm, then K1 for the act grid) and
        # the 44 self-attentions' in- and out-projections (both grids off; library_ms: torch.addmm). launches:
        # phase 33's 16 KD steps, student and teacher. htdemucs_*: phase 59's, its projections included. bound_ms: the float32 CUDA-core bound (comparable with earlier runs);
        # route_bound_ms: the bound of the route the kernel takes (3 TF32 products a float32 one), K5-bwd and K3
        # likewise.
        # bf16_*: the bf16 route (phase 43) per DPTNet + Sepformer bf16 serving forward at 8 x 4 s (phases 41-42;
        # ConvTasNet has no QDense), the projections included; bf16_library_ms:
        # torch.mm of the operands cast to bf16 with a float32 output, the bias, then K1 (a projection: no K1; null,
        # with bf16_library_note, where torch has no such call).
        dict(name="qat_dense", route="cuda", route_detail=DENSE_ROUTE, source="fqss_tpu_torch/csrc/qat_dense.cu",
             replaces="fqss_tpu/ops/pallas_qat.py:347", launches=train_model_launches["dense"], **dense_fwd,
             **bf16_keys(dense16, bf16_count["dense_bf16"], BF16_DENSE_ROUTE),
             bf16_library_note=dense16["library_note"], htdemucs_launches=htd_launches["dense"],
             **{f"htdemucs_{k}": htd["k5"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "route_bound_ms",
                                                        "max_abs_err")}),
        # K5's GELU route (QDense(nl="gelu")): ms, plain_ms, bound_ms, library_ms: one HTDemucs forward's 10 linear1
        # launches at 8 x 441,000 (phase 59); library_ms: torch.addmm, F.gelu, then K1. launches: phase 54's forward.
        dict(name="qat_dense_gelu", route="cuda", route_detail=DENSE_ROUTE + "; the exact GELU (erfcf) between the "
             "bias and the act grid", source="fqss_tpu_torch/csrc/qat_dense.cu",
             replaces="fqss_tpu/ops/pallas_qat.py:347",
             launches=htd_launches["dense_gelu"],
             **{k: htd["k5_gelu"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "route_bound_ms",
                                               "max_abs_err")}),
        # The backward of those 166 launches: the mask, dx and dwq kernels of each (and their fixed-order sums);
        # library_ms: the two products by torch.mm and K1-bwd on the pre-activation (a projection: the bias's sum). launches: phase 33's mask
        # launches (each with one dx and one dwq launch).
        dict(name="qat_dense_bwd", route="cuda", route_detail=DENSE_ROUTE, source="fqss_tpu_torch/csrc/qat_dense.cu",
             replaces="fqss_tpu/ops/pallas_qat.py:364", launches=train_model_launches["dense_mask"], **dense_bwd,
             htdemucs_launches=htd_train_launches["dense_mask"]),
        # K5-bwd's GELU route (QDense(nl="gelu") under a gradient): ms, plain_ms, bound_ms, library_ms: one htdemucs
        # KD step's 10 linear1 backward launches at phase 62's batch (phase 61), the weight grid off (the weight
        # pass's) and the act grid on; library_ms: two torch.mm, torch's GELU backward and K1-bwd on the forward's
        # saved pre-activation and GELU output; the bound counts the products (the GELU's erfcf and expf are under 1%
        # of the operations). launches: phase 62's mask launches on the route (each with one dx and one dwq launch).
        dict(name="qat_dense_bwd_gelu", route="cuda", route_detail=DENSE_ROUTE + "; the mask pass takes the act grid's "
             "mask at gelu(pre) and multiplies by gelu'(pre) (erfcf, expf), as JAX's autodiff of the GELU",
             source="fqss_tpu_torch/csrc/qat_dense.cu", replaces="fqss_tpu/ops/pallas_qat.py:496",
             launches=htd_train_launches["dense_mask_gelu"],
             **{k: htd_train["gelu_bwd"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                                       "route_bound_ms", "max_abs_err")}),
        # ms, plain_ms, bound_ms, library_ms: one DPTNet and one Sepformer serving forward's launches at 8 x 4 s
        # (DPTNet's BN, the Sepformer masker's conv1d; phase 37); library_ms: torch.matmul, then K1 for the act grid.
        # launches: phase 18's and phase 25's forwards.
        # bf16_*: as qat_dense's, per DPTNet + Sepformer bf16 forward; bf16_library_ms: torch.bmm of bf16 operands with
        # a float32 output, then K1.
        dict(name="qmatmul", route="cuda", route_detail=DENSE_ROUTE, source="fqss_tpu_torch/csrc/qat_dense.cu",
             replaces="fqss_tpu/ops/pallas_quant.py:90", launches=dpt_launches["qmatmul"] + sep_launches["qmatmul"],
             **qmm, **bf16_keys(qmm16, bf16_count["qmatmul_bf16"], BF16_DENSE_ROUTE),
             bf16_library_note=qmm16["library_note"], music_launches=music["launches"]["qmatmul"],
             **{f"music_{k}": music_k3[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}),
    ]
    # import_launches: the launches of phase 66's imported forwards and phase 68's KD steps from pretrained, summed.
    rows = {"act_fake_quant": "act", "weight_fake_quant": "weight", "act_fake_quant_bwd": "act_bwd",
            "weight_fake_quant_bwd": "weight_bwd", "int8_matmul_requant": "int8_mm", "bilstm_sequence": "bilstm",
            "lstm_sequence": "lstm", "bilstm_static_sequence": "bilstm_static", "lstm_static_sequence": "lstm_static",
            "fused_attention": "attention", "qat_dense": "dense",
            "qat_dense_gelu": "dense_gelu", "qat_dense_bwd": "dense_mask", "qat_dense_bwd_gelu": "dense_mask_gelu",
            "qmatmul": "qmatmul"}
    # variant_launches: the launches of phases 69-71's steps and forwards, summed. ddp_launches: phases 75-78's, the
    # ranks' summed (the flagship's steps on two ranks and on the one-rank NCCL group, the static DPTNet step, the
    # sharded OLA) and the dry run's sharded OLA (its phase 2, on phase 81's ranks); tp_launches: phases 80-81's, the
    # ranks' summed; fsdp_launches: phase 75's FSDP steps, phase 76's FSDP step and the dry run's FSDP step (its phase
    # 3); pp_launches: phase 76's single-stage call, the dry run's 2-stage call (its phase 4) and phase 82's calls; the
    # one-process comparisons are not counted.
    fsdp_paths = [ddp.pop("fsdp"), ddp.pop("nccl fsdp"), tensor["fsdp"]]
    pp_paths = [ddp.pop("nccl pp"), *tensor["pp"].values()]
    ddp["dry run sp"] = tensor["sp"]
    for row in kernels:
        row["import_launches"] = imported.get(rows.get(row["name"]), 0)
        row["variant_launches"] = variants["launches"].get(rows.get(row["name"]), 0)
        for key, paths in (("ddp_launches", ddp.values()), ("tp_launches", tensor["tp"].values()),
                           ("fsdp_launches", fsdp_paths), ("pp_launches", pp_paths)):
            row[key] = sum(path.get(rows.get(row["name"]), 0) for path in paths)
    # the grouped weight kernels at DPTNet's 93 quantizers with the trained residual decoder (phase 71)
    for row, res in ((kernels[1], variants["res_dec"]["groups"]), (kernels[3], variants["res_dec"]["group_bwd"])):
        row.update({f"res_dec_{k}": res[k] for k in ("ms", "bound_ms", "plain_ms", "max_abs_err")})
    kernels[0]["mulaw_max_abs_err"] = variants["mulaw"]["max_abs_err"]
    for msg in _STANDING:
        log(f"[standing failure] {msg}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        ddp_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--tp-worker"]:
        tp_worker(sys.argv[2])
    else:
        main()
