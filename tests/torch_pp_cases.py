"""The pipeline cases of ``tests/test_torch_pp.py``, and the rank worker that runs them.

Run as ``python tests/torch_pp_cases.py OUT_DIR [DEVICE]`` with torchrun's variables (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) in the environment: each of four ranks joins a gloo group on the CPU, is one stage
of a 4-stage pipeline of ``tests/test_pp.py``'s ``TransformerLayer(16, 32, 4)`` stacks (the layers' states in
``OUT_DIR/inputs.pt``, converted from JAX's variables) and writes what it saw to ``OUT_DIR/rank<r>.pt``; on a card
(``DEVICE`` ``cuda:0``, gloo: the ranks share it) two ranks run :func:`card_case` alone. It imports no
JAX: the test process holds the results to JAX's ``pipeline_layer_module`` and to the sequential stacks.
"""

from __future__ import annotations

import os
import sys

import torch

from fqss_tpu_torch.models.sepformer import TransformerLayer
from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.parallel import pp
from fqss_tpu_torch.quant.quantizers import read_only, weight_pass
from fqss_tpu_torch.quant.spec import QuantSpec

F, FFN, HEADS, L = 16, 32, 4, 40  # tests/test_pp.py's [B, L, F] tokens
BATCH = 8
STAGES = 4
QAT = dict(qat=True, observer=False)  # tests/test_pp.py:84
WINDOW = dict(qat=True, observer=True, max_observations=50)  # observers on, their window open


def layers(states: list[dict] | None, q: QuantSpec = QuantSpec(), n: int = 4, seed: int = 10) -> list[TransformerLayer]:
    """The stack: ``states`` loaded (the seeds' own init where None)."""
    out = []
    for i in range(len(states) if states is not None else n):
        layer = TransformerLayer(F, FFN, HEADS, q=q, generator=torch.Generator().manual_seed(seed + i))
        if states is not None:
            layer.load_state_dict(states[i])
        out.append(layer)
    return out


def sequential(stack: list[TransformerLayer], x: torch.Tensor) -> torch.Tensor:
    """The stack applied in order as a pipeline's stages apply it (one weight pass, no state writes)."""
    modules = torch.nn.ModuleList(stack)
    with read_only(), weight_pass(modules):
        for layer in modules:
            x = layer(x)
    return x


def state_of(stack) -> dict:
    return {f"{i}.{k}": v.detach().clone() for i, layer in enumerate(stack) for k, v in layer.state_dict().items()}


def stage_grads(stage: pp.Stage) -> dict:
    """The stage's gradients by the whole stack's layer index."""
    n = len(stage)
    return {f"{stage.index * n + i}.{k}": p.grad.detach().clone() for i, layer in enumerate(stage)
            for k, p in layer.named_parameters() if p.grad is not None}


def card_case(mesh: pp.PipelineMesh, device) -> dict:
    """The seeds' 4-layer float stack as this rank's stage of ``mesh`` on ``device``: the pipelined forward of
    :func:`card_input` at 2 microbatches and the stage's gradients of ``sum(y^2)``."""
    stage = pp.shard_layer_stack([layer.to(device) for layer in layers(None)], mesh)
    y = pp.pipeline_layer_module(stage, card_input().to(device), mesh, n_microbatches=2)
    y.square().sum().backward()
    return {"y": y.detach().cpu(), "grads": {k: g.cpu() for k, g in stage_grads(stage).items()}}


def card_input() -> torch.Tensor:
    return torch.randn(BATCH, L, F, generator=torch.Generator().manual_seed(0))


def worker(out_dir: str, device: str = "cpu") -> None:
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    world = dp.init_distributed(device, backend="gloo")
    try:
        mesh = pp.pipeline_mesh(world)
        if world.device.type == "cuda":
            torch.save(card_case(mesh, world.device), os.path.join(out_dir, f"rank{world.rank}.pt"))
            return
        inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=True)
        x = inputs["x"]
        result: dict = {"stage": (mesh.rank, mesh.size)}
        with torch.no_grad():
            for name, states, q, m in (("float_m2", inputs["float4"], QuantSpec(), 2),
                                       ("float_m4", inputs["float4"], QuantSpec(), 4),
                                       ("float_8_layers", inputs["float8"], QuantSpec(), None),
                                       ("qat", inputs["qat4"], QuantSpec(**QAT), None)):
                stage = pp.shard_layer_stack(layers(states, q), mesh)
                result[name] = (len(stage), pp.pipeline_layer_module(stage, x, mesh, n_microbatches=m))
        stage = pp.shard_layer_stack(layers(inputs["float4"]), mesh)
        pp.pipeline_layer_module(stage, x, mesh).square().sum().backward()
        result["grads"] = stage_grads(stage)
        # observers on, inside their window, in train() mode: the pipelined forward and backward write nothing
        stage = pp.shard_layer_stack(layers(None, QuantSpec(**WINDOW)), mesh).train()
        before = state_of(stage)
        pp.pipeline_layer_module(stage, x, mesh).square().sum().backward()
        after = state_of(stage)
        result["window"] = {"keys": sorted(before), "changed": sorted(k for k in before if not torch.equal(before[k],
                                                                                                          after[k]))}
        torch.save(result, os.path.join(out_dir, f"rank{world.rank}.pt"))
    finally:
        dp.shutdown()


if __name__ == "__main__":
    worker(*sys.argv[1:3])
