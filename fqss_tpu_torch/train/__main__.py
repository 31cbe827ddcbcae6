"""Training CLI on PyTorch (the port of ``train.py``).

Usage: python -m fqss_tpu_torch.train -env {asteroid,speechbrain,tasnet,htdemucs} -y cfg.yaml [--device cuda]

Runs :func:`fqss_tpu_torch.train.recipes.train_speech` on ``--device``
(default ``cuda``, which must be present; ``--device cpu`` runs the plain
PyTorch versions of the kernels on the CPU) for the config's model:
ConvTasNet, DPTNet (``-env asteroid -y configs/dptnet_2spks_8k.yaml``) or
the Sepformer (``-env speechbrain -y configs/sepformer_2spks_8k.yaml``);
``-env tasnet`` runs the music recipe
:func:`fqss_tpu_torch.train.recipes_music.train_tasnet_music`
(``-y configs/convtasnet_music.yaml``, MUSDB18-HQ) and ``-env htdemucs``
:func:`fqss_tpu_torch.train.recipes_music.train_htdemucs`
(``-y configs/htdemucs.yaml``, or a config in the reference's hydra schema).
``-y`` takes a YAML config, or the same config as a ``.json`` file, which
needs no YAML parser. TF32 is turned off: it would move values off the
8-bit grids.

Data parallelism: ``torchrun --standalone --nproc_per_node=N -m
fqss_tpu_torch.train ...`` (or ``python -m torch.distributed.run ...``)
trains over N ranks, rank r on ``cuda:LOCAL_RANK`` over NCCL (``--device
cpu``: gloo on the CPU); the config's ``batch_size`` is the global batch
and must divide by N (``parallel/mesh.py``). A plain ``python -m`` runs one
process.
"""

from __future__ import annotations

import argparse

from fqss_tpu_torch.infer import disable_tf32, resolve_device
from fqss_tpu_torch.parallel import mesh as dp


def argument_handler(argv=None):
    parser = argparse.ArgumentParser(prog="python -m fqss_tpu_torch.train")
    parser.add_argument("--env_name", "-env", type=str, required=True,
                        choices=["asteroid", "speechbrain", "tasnet", "htdemucs"], help="Training environment (recipe)")
    parser.add_argument("--yml_path", "-y", type=str, required=True, help="YML configuration file")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = argument_handler(argv)
    from fqss_tpu_torch.utils.config import load_config

    conf = load_config(args.yml_path)
    mesh = dp.init_distributed(args.device)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    disable_tf32()
    try:
        if args.env_name in ("tasnet", "htdemucs"):
            from fqss_tpu_torch.train.recipes_music import train_htdemucs, train_tasnet_music

            train = train_htdemucs if args.env_name == "htdemucs" else train_tasnet_music
            result = train(conf, device=device, mesh=mesh)
            done = (f"Training done: best train loss {result['best_loss']:.4f} after {result['epochs_run']} epochs "
                    f"(last epoch's best model: {result['bname']})")
        else:
            from fqss_tpu_torch.train.recipes import train_speech

            result = train_speech(conf, env_name=args.env_name, device=device, mesh=mesh)
            done = f"Training done: best val_loss {result['best_val_loss']:.4f} after {result['epochs_run']} epochs"
        if mesh is None or mesh.is_main:
            print(done)
    finally:
        dp.shutdown()


if __name__ == "__main__":
    main()
