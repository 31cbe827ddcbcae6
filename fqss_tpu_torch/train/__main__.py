"""Training CLI on PyTorch (the port of ``train.py``).

Usage: python -m fqss_tpu_torch.train -env {asteroid,speechbrain} -y cfg.yaml [--device cuda]

Runs :func:`fqss_tpu_torch.train.recipes.train_speech` on ``--device``
(default ``cuda``, which must be present; ``--device cpu`` runs the plain
PyTorch versions of the kernels on the CPU) for the config's model:
ConvTasNet, DPTNet (``-env asteroid -y configs/dptnet_2spks_8k.yaml``) or
the Sepformer (``-env speechbrain -y configs/sepformer_2spks_8k.yaml``).
``-y`` takes a YAML config, or the same config as a ``.json`` file, which
needs no YAML parser. TF32 is turned off: it would move values off the
8-bit grids. The music environments (``tasnet``, ``htdemucs``) are not
ported yet.
"""

from __future__ import annotations

import argparse

from fqss_tpu_torch.infer import disable_tf32, resolve_device


def argument_handler(argv=None):
    parser = argparse.ArgumentParser(prog="python -m fqss_tpu_torch.train")
    parser.add_argument("--env_name", "-env", type=str, required=True,
                        choices=["asteroid", "speechbrain", "tasnet", "htdemucs"], help="Training environment (recipe)")
    parser.add_argument("--yml_path", "-y", type=str, required=True, help="YML configuration file")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = argument_handler(argv)
    if args.env_name in ("tasnet", "htdemucs"):
        raise NotImplementedError(f"-env {args.env_name} is not ported yet (the music recipes, ROADMAP.md queue 1)")
    from fqss_tpu_torch.train.recipes import train_speech
    from fqss_tpu_torch.utils.config import load_config

    conf = load_config(args.yml_path)
    device = resolve_device(args.device)
    disable_tf32()
    result = train_speech(conf, env_name=args.env_name, device=device)
    print(f"Training done: best val_loss {result['best_val_loss']:.4f} after {result['epochs_run']} epochs")


if __name__ == "__main__":
    main()
