#!/usr/bin/env python3
"""How far two runs of the same full-width FQSS-8bit DPTNet land apart: its own noise floor.

Usage: python3 scripts/dptnet_noise_floor.py          (on a machine with one NVIDIA GPU)
       JAX_PLATFORMS=cpu python scripts/dptnet_noise_floor.py --jax     (the JAX package, on the CPU)

Card mode: the DPTNet of ``chip_smoke.py`` (seeded weights, 8 x 4 s mixtures)
calibrated by a 3-step and by the config's 50-step observer window; for
each, the card against the CPU on the same weights at 1 x 1 s (SNR per
output, mean |difference| in output steps, the output's rms in steps). Then,
for the 50-step model, the same comparison with the quantizers taken out
(the float model on the same weights), the share of values that differ after
each dual-path layer, and the card's forward with the LSTM kernel against
the card's forward with the plain recurrence.

``--jax`` mode: the JAX package's full-width DPTNet (its own seeded init),
calibrated the same two ways, jitted against jitted with XLA's algebraic
simplifier off (eager JAX's arithmetic) at 1 x 1 s: the floor the JAX
package has against itself. Takes a few minutes on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = (3, 50)


def snr_db(ref: np.ndarray, est: np.ndarray) -> np.ndarray:
    return 10 * np.log10(np.sum(ref**2, -1) / np.maximum(np.sum((ref - est) ** 2, -1), 1e-30))


def card() -> None:
    import torch

    import chip_smoke as cs
    from fqss_tpu_torch.infer import disable_tf32
    from fqss_tpu_torch.models.dptnet import DPTNet, ImprovedTransformerLayer
    from fqss_tpu_torch.models.factory import create_pretrained_model
    from fqss_tpu_torch.nn import lstm as qlstm
    from fqss_tpu_torch.ops import lstm
    from fqss_tpu_torch.quant.spec import QuantSpec

    if not torch.cuda.is_available():
        raise SystemExit("dptnet_noise_floor: no CUDA device (use --jax for the JAX package on the CPU)")
    dev = torch.device("cuda", 0)
    disable_tf32()
    print(torch.cuda.get_device_name(0))
    mix, _ = cs.synth_batch(np.random.default_rng(18), cs.DPT_BATCH, 2, cs.DPT_SEG)
    x = torch.from_numpy(mix[:1, : cs.SR])
    for steps in STEPS:
        dpt = cs.build_served_dptnet(dev, mix[:2], steps)
        cpu = create_pretrained_model(cs.DPTNET_CFG, observer=False)
        cpu.load_state_dict(dpt.state_dict())
        with torch.inference_mode():
            y_card, y_cpu = dpt(x.to(dev)).cpu().numpy(), cpu(x).numpy()
        lsb = cs.out_step(dpt)
        print(f"observer {steps} steps: card vs CPU SNR {np.round(snr_db(y_cpu, y_card).ravel(), 2).tolist()} dB, "
              f"mean {np.abs(y_card - y_cpu).mean() / lsb:.4f} output steps, output rms "
              f"{np.sqrt(np.mean(y_cpu**2)) / lsb:.2f} steps", flush=True)

    spec = QuantSpec(n_splitter=2, n_combiner=2)  # no quantizers: the float model on the same weights
    weights = {k: v for k, v in dpt.state_dict().items() if "quantiz" not in k and ".wq_" not in k}
    floats = [DPTNet(q=spec) for _ in range(2)]
    for m in floats:
        m.load_state_dict(weights)
    with torch.inference_mode():
        y_card, y_cpu = floats[0].to(dev).eval()(x.to(dev)).cpu().numpy(), floats[1].eval()(x).numpy()
    print(f"float model card vs CPU SNR {np.round(snr_db(y_cpu, y_card).ravel(), 2).tolist()} dB")

    outs = ({}, {})
    for model, store in ((dpt, outs[0]), (cpu, outs[1])):
        for name, m in model.named_modules():
            if isinstance(m, ImprovedTransformerLayer):
                m.register_forward_hook(
                    lambda mod, args, out, name=name, store=store: store.__setitem__(name, out.cpu()))
    with torch.inference_mode():
        dpt(x.to(dev))
        cpu(x)
    for name, want in outs[1].items():
        diff = (outs[0][name] - want).abs()
        print(f"  after {name}: {(diff > 0).float().mean().item():.5f} of values differ, max {diff.max().item():.4g}")

    with torch.inference_mode():
        y_kernel = dpt(x.to(dev))
        qlstm.bilstm_sequence = lstm.bilstm_sequence_ref
        y_plain = dpt(x.to(dev))
    print(f"card forward with K7 vs with the plain recurrence: bitwise equal {torch.equal(y_kernel, y_plain)}, "
          f"max |difference| {(y_kernel - y_plain).abs().max().item():.3g}")


def jax_floor() -> None:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    from fqss_tpu.data import synth_batch
    from fqss_tpu.models.dptnet import DPTNet
    from fqss_tpu.quant import QuantSpec
    from fqss_tpu.quant.calibration import run_observer

    mix, _ = synth_batch(np.random.default_rng(18), 2, 2, 32000)
    x = jnp.asarray(mix[:1, :8000])
    for steps in STEPS:
        spec = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=steps)
        obs = DPTNet(q=QuantSpec(observer=True, **spec))
        variables = jax.jit(obs.init)(jax.random.PRNGKey(0), x)
        variables = run_observer(obs, variables, jnp.asarray(mix), steps=steps)
        model = DPTNet(q=QuantSpec(observer=False, **spec))
        jitted = np.asarray(jax.jit(model.apply)(variables, x))
        eager = np.asarray(jax.jit(model.apply).lower(variables, x).compile(
            compiler_options={"xla_disable_hlo_passes": "algsimp"})(variables, x))
        qp = variables["qparams"]["decoder"]["activation_fake_quantize"]
        lsb = float(np.asarray(qp["max_range"]).ravel()[0] - np.asarray(qp["min_range"]).ravel()[0]) / 255
        print(f"JAX, observer {steps} steps: jit vs jit without algsimp SNR "
              f"{np.round(snr_db(eager, jitted).ravel(), 2).tolist()} dB, mean "
              f"{np.abs(jitted - eager).mean() / lsb:.4f} output steps, output rms "
              f"{np.sqrt(np.mean(eager**2)) / lsb:.2f} steps", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(prog="python3 scripts/dptnet_noise_floor.py")
    parser.add_argument("--jax", action="store_true", help="measure the JAX package on the CPU instead")
    jax_floor() if parser.parse_args().jax else card()


if __name__ == "__main__":
    main()
