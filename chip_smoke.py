#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Usage: python3 chip_smoke.py     (from the repository root; needs one CUDA device)

Drives the port's two paths, the FQSS-8bit ConvTasNet serving forward and its
KD train step, at full width (512 filters, bottleneck 128, hidden 512,
8 blocks x 3 repeats, n_splitter = n_combiner = 2, 8-bit weights and
activations), with random weights from seeded ``torch.Generator``s. It prints
one line per phase and lets any failure propagate:

0. device: the card's name and power limit (nvidia-smi); TF32 off.
1. build: compile ``fqss_tpu_torch/csrc/fake_quant.cu`` with nvcc.
2. kernels vs their plain PyTorch versions on the card, bitwise
   (``torch.equal``), at the main path's shapes, with planted edge and
   half-step tie values; CUDA-event times of both.
3. the full-width model: an observer pass sets the ranges, then one forward
   of 32 x 12 s at 8 kHz; the launch counters must rise by exactly the
   number of quantizer modules.
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
   sizes and the 7 weight shapes on channel axes 0 and 1; CUDA-event times.
9. KD training at full width: student and float teacher from
   ``create_model_and_teacher``, 8 steps of 2 x 3 s through
   ``make_train_step`` with a 3-step observer window; every step must launch
   each forward kernel once per quantizer module and each backward kernel
   once per quantizer whose output reaches the loss.
10. card vs CPU: one post-window step from the same state at 1 x 1 s; loss
    and whole-gradient cosine within LOSS_DB_TOL and GRAD_COS_MIN.
11. train-step time at 16 x 3 s: ms per step, seconds of audio trained per
    second, peak device memory.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from fqss_tpu_torch import infer
from fqss_tpu_torch.data.synthetic import synth_batch
from fqss_tpu_torch.models.convtasnet import ConvTasNet
from fqss_tpu_torch.models.factory import create_model_and_teacher
from fqss_tpu_torch.ops import _build
from fqss_tpu_torch.ops import fake_quant as fq
from fqss_tpu_torch.quant.quantizers import ActQuantizer, WeightQuantizer
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.serve.fold import fold_quantized_weights
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


def log(msg: str) -> None:
    print(msg, flush=True)


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
    return results


def build_served_model(dev, mix: np.ndarray, **arch) -> ConvTasNet:
    """Seeded full-width model whose ranges come from a 3-step observer pass in train mode."""
    q_obs = dataclasses.replace(SPEC, observer=True, max_observations=3)
    model = ConvTasNet(n_srcs=2, kernel_size=16, stride=8, q=q_obs,
                       generator=torch.Generator().manual_seed(0), **arch).to(dev)
    model.train()
    x = torch.from_numpy(mix).to(dev)
    with torch.no_grad():
        for _ in range(3):
            model(x)
    served = ConvTasNet(n_srcs=2, kernel_size=16, stride=8, q=SPEC, **arch)
    served.load_state_dict(model.state_dict())
    return served.to(dev).eval()


def snr_db(ref: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    return 10 * torch.log10(ref.pow(2).sum(-1) / (ref - est).pow(2).sum(-1))


def serve_requests(dev, served: ConvTasNet, model_cfg: dict, seconds: int = 20) -> list[float]:
    """Serve three synthetic mixtures through the infer entry; returns each request's seconds."""
    latencies = []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "convtasnet_fqss8bit.pt")
        torch.save(served.state_dict(), ckpt)
        conf = {"model_cfg": {**model_cfg, "model_path": ckpt},
                "testing_cfg": {"segment_samples": 16000, "overlap": 0.25}}
        apply_fn = infer.load_engine(conf["model_cfg"], "folded", dev)
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
    want = {**fwd, "act_bwd": bwd["act"], "weight_bwd": bwd["weight"]}
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
        f"after the window; every step launched act={want['act']} weight={want['weight']} forward (= quantizer modules) "
        f"and act_bwd={want['act_bwd']} weight_bwd={want['weight_bwd']} backward (= quantizers reaching the "
        f"loss; the last block's residual branch feeds nothing)")
    return state, launches


def card_vs_cpu_step(dev, state: TrainState) -> tuple[float, float]:
    """Phase 10: one post-window train step from the same state on the card and on the CPU.

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
    log(f"[10] card vs CPU train step at 1 x {SR}: loss {loss_card:.5f} vs {loss_cpu:.5f} dB (|diff| {diff:.2e} <= "
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


def main() -> None:
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

    # 2. kernels vs plain versions on the card
    act = check_act_kernel(dev)
    weight = check_weight_kernel(dev)
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
    if launches != {"act": n_act, "weight": n_weight, "act_bwd": 0, "weight_bwd": 0}:
        raise AssertionError(f"launches {launches} != quantizer modules act={n_act} weight={n_weight}")
    log(f"[3] full-width forward {tuple(x.shape)} -> {tuple(y.shape)}, finite, {n_params} parameters, "
        f"first call {first_s:.2f} s; launches act={launches['act']} weight={launches['weight']} "
        f"= quantizer modules ({n_act}, {n_weight})")

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
    log(f"[4] card vs CPU at 1 x {SR}: SNR {[round(v, 2) for v in snr.flatten().tolist()]} dB (>= 20), "
        f"{(y_card != y_cpu).float().mean().item():.4f} of samples differ")

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
    latencies = serve_requests(dev, served, MODEL_CFG)
    for i, s in enumerate(latencies):
        log(f"[6] request {i}: 20 s mixture -> 2 sources of 20 s, {s * 1000:.1f} ms")

    # 7. throughput of both engines
    audio_s = BATCH * SEG / SR
    for name, model in (("fake_quant", served), ("folded", folded)):
        with torch.inference_mode():
            ms = cuda_ms(lambda: model(x), 3)
        log(f"[7] throughput {name}: {audio_s / (ms / 1000):.1f} sec-audio/s ({ms:.1f} ms per forward of "
            f"{BATCH} x {SEG // SR} s) on {smi}")
    del served, folded, model, x, y, y_folded
    torch.cuda.empty_cache()

    # 8. backward kernels vs plain versions on the card
    act_bwd = check_act_bwd_kernel(dev)
    weight_bwd = check_weight_bwd_kernel(dev)
    torch.cuda.empty_cache()

    # 9. KD training at full width (launch counts set to 0 inside, read after the last step)
    state, train_launches = train_at_full_width(dev)

    # 10. card vs CPU on one train step
    card_vs_cpu_step(dev, state)

    # 11. train-step time
    train_step_time(dev, state, smi)

    source = "fqss_tpu_torch/csrc/fake_quant.cu"
    kernels = [
        dict(name="act_fake_quant", route="cuda", source=source, replaces="fqss_tpu/ops/pallas_qat.py:87",
             launches=launches["act"], **act),
        dict(name="weight_fake_quant", route="cuda", source=source, replaces="fqss_tpu/ops/pallas_qat.py:204",
             launches=launches["weight"], **weight),
        dict(name="act_fake_quant_bwd", route="cuda", source=source, replaces="fqss_tpu/ops/pallas_qat.py:95",
             launches=train_launches["act_bwd"], **act_bwd),
        dict(name="weight_fake_quant_bwd", route="cuda", source=source, replaces="fqss_tpu/ops/pallas_qat.py:214",
             launches=train_launches["weight_bwd"], **weight_bwd),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
