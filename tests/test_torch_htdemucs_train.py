"""One htdemucs KD step of the port against JAX's ``make_music_train_step``, on the CPU.

A tiny HTDemucs (8 channels, depth 2, two transformer layers: one
self-attention pair and one cross-attention pair, nfft 512, 8 kHz) takes the
port's seeded init, its observer window closed by four of the port's calls in
``train()`` mode, and is carried to JAX with :func:`to_jax` (the inverse of
``htdemucs_from_jax``), its float teacher likewise. JAX runs its step
(``is_htdemucs=True``, ``weight_kind="exp"``, source weights, one batch EMA
of decay 0.9, the per-module optimizer groups with ``t_lr`` and
``t_weight_decay``, augmentation off) jitted with XLA's algebraic simplifier
off; the port runs ``make_music_train_step`` with the same settings.

Bound: the whole model is chaotic at the grid level (XLA's FFT, ``erfc`` and
sums and PyTorch's differ in the last bits, which moves values across the
first encoder's rounding ties; ``tests/test_torch_htdemucs.py`` holds the
forward by SNR). So each quantity is held to JAX's own floor: JAX's step
against itself on the stems times (1 + 2^-22), the distance between the two
(the loss's and the gradients' norm's absolute difference, the L2 distance
of the updated parameters and ranges, and of the EMA). The port's distance
from JAX's step on the stems must be at most FLOOR_FACTOR times that floor.
On the CPU (torch 2.13.0, jax 0.9.0) the port read 5.1x the floor on the loss (3.1e-7 against
6.0e-8), 2.3x on the gradients' norm (3.9e-6 against 1.7e-6), 1.5x on the
parameters and the EMA (2.1e-3 against 1.4e-3, the EMA's a tenth of those);
the test prints them (``pytest -s``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fqss_tpu.models.htdemucs import HTDemucs as JaxHTDemucs
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.train.recipes_music import make_music_optimizer as jax_make_music_optimizer
from fqss_tpu.train.recipes_music import make_music_train_step as jax_make_music_train_step
from fqss_tpu.train.state import create_train_state
from fqss_tpu.train.trainer import TrainConfig as JaxTrainConfig
from fqss_tpu_torch.data.synthetic import synth_music_batch
from fqss_tpu_torch.models.convert import htdemucs_from_jax
from fqss_tpu_torch.models.htdemucs import HTDemucs
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.train.recipes_music import _params_copy, make_music_optimizer, make_music_train_step
from fqss_tpu_torch.train.state import TrainState
from fqss_tpu_torch.train.trainer import TrainConfig

torch.set_num_threads(1)

TINY = dict(channels=8, nfft=512, depth=2, t_layers=2, t_heads=4, segment=0.5, samplerate=8000)
SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=3)
SR = 8000
WEIGHTS = np.asarray([1.0, 2.0, 1.0, 0.5], np.float32)
MODEL_CFG = {"t_lr": 1e-3, "t_weight_decay": 0.05}
PERTURB = 2.0**-22
FLOOR_FACTOR = 10.0


def to_jax(port, jax_model, x):
    """The JAX variables of ``jax_model`` holding ``port``'s state: :func:`htdemucs_from_jax` run on a tree of element
    indices gives each port tensor's place in JAX's leaves (``tests/test_torch_htdemucs.py``)."""
    shapes = jax.eval_shape(lambda x: jax_model.init(jax.random.PRNGKey(0), x, train=True), jnp.asarray(x))
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    sizes = np.cumsum([0] + [leaf.size for leaf in leaves])
    index = jax.tree_util.tree_unflatten(tree, [np.arange(a, b).reshape(leaf.shape)
                                                for a, b, leaf in zip(sizes[:-1], sizes[1:], leaves)])
    flat = np.zeros(sizes[-1])
    state = port.state_dict()
    places = htdemucs_from_jax(index)
    assert places.keys() == state.keys()
    for key, place in places.items():
        flat[place.numpy().ravel()] = state[key].double().numpy().ravel()
    return jax.tree_util.tree_unflatten(tree, [flat[a:b].reshape(leaf.shape).astype(leaf.dtype)
                                               for a, b, leaf in zip(sizes[:-1], sizes[1:], leaves)])


def _flat(sd):
    """The parameters and ranges of a port state dict as one vector (the observers' counters left out)."""
    return np.concatenate([sd[k].numpy().ravel() for k in sorted(sd) if not k.endswith(("n_iter", "observed"))])


@pytest.fixture(scope="module")
def models():
    """(port student with its window closed, port teacher, stems [2, 4, 2, 4000])."""
    stems = synth_music_batch(np.random.default_rng(1), 2, 4000, sample_rate=SR)
    student = HTDemucs(q=QuantSpec(observer=True, **SPEC), **TINY, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for _ in range(SPEC["max_observations"] + 1):
            student.train()(torch.from_numpy(stems.sum(1)))
    teacher = HTDemucs(**TINY, generator=torch.Generator().manual_seed(1))
    return student, teacher, stems


def test_one_htdemucs_kd_step_matches_jax_within_its_own_floor(models):
    student, teacher, stems = models
    mix = stems.sum(1)
    jm = JaxHTDemucs(q=JaxQuantSpec(observer=True, **SPEC), **TINY)
    jt = JaxHTDemucs(**TINY)
    variables, teacher_vars = to_jax(student, jm, mix), to_jax(teacher, jt, mix)
    jcfg = JaxTrainConfig(kd_lambda=0.1, lr=3e-4, grad_clip=0.0)
    tx = jax_make_music_optimizer(jcfg, MODEL_CFG, {"params": variables["params"], "qparams": variables["qparams"]})
    step = jax_make_music_train_step(jm, jt, tx, jcfg, weight_kind="exp", augment_cfg={"enable": False},
                                     is_htdemucs=True, batch_ema_decays=(0.9,), source_weights=WEIGHTS)

    def fresh():
        state = create_train_state(variables, tx, teacher_params=teacher_vars["params"])
        return state, (jax.tree_util.tree_map(jnp.array, {"params": state.params, "qparams": state.qparams}),)

    args = (*fresh(), jnp.asarray(stems), jax.random.PRNGKey(0))
    compiled = step.lower(*args).compile(compiler_options={"xla_disable_hlo_passes": "algsimp"})
    runs = []
    for scale in (1.0, 1.0 + PERTURB):
        state, emas, metrics = jax.device_get(compiled(*fresh(), jnp.asarray(stems * np.float32(scale)),
                                                       jax.random.PRNGKey(0)))
        qstats = jax.device_get(variables["qstats"])
        runs.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                     _flat(htdemucs_from_jax({"params": state.params, "qparams": state.qparams, "qstats": qstats})),
                     _flat(htdemucs_from_jax({**emas[0], "qstats": qstats}))))

    model = HTDemucs(q=QuantSpec(observer=True, **SPEC), **TINY)
    model.load_state_dict(student.state_dict())
    ref = HTDemucs(**TINY)
    ref.load_state_dict(teacher.state_dict())
    cfg = TrainConfig(kd_lambda=0.1, lr=3e-4, grad_clip=0.0)
    state = TrainState(model, make_music_optimizer(cfg, MODEL_CFG, model), ref.requires_grad_(False).eval())
    emas = [_params_copy(model)]
    port_step = make_music_train_step(cfg, {"enable": False}, weight_kind="exp", is_htdemucs=True,
                                      source_weights=WEIGHTS, batch_ema_decays=(0.9,))
    metrics = port_step(state, torch.from_numpy(stems), None, emas)
    assert not metrics["skipped"] and state.step == 1
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    got = (float(metrics["loss"]), float(metrics["grad_norm"]), _flat(sd), _flat({**sd, **emas[0]}))

    (want, own) = runs
    start = _flat(student.state_dict())
    assert np.linalg.norm(want[2] - start) > 10 * np.linalg.norm(own[2] - want[2])  # the step moved the model
    for i, name in enumerate(("loss", "grad_norm", "parameters", "EMA")):
        floor = float(np.linalg.norm(np.subtract(own[i], want[i])))
        dist = float(np.linalg.norm(np.subtract(got[i], want[i])))
        print(f"{name}: {dist:.2e} from JAX's step, JAX's own floor {floor:.2e} ({dist / floor:.2f}x)")
        assert 0 < floor and dist <= FLOOR_FACTOR * floor, (name, dist, floor, FLOOR_FACTOR)
