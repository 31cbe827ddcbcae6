"""Data parallelism over ``torch.distributed`` (``fqss_tpu_torch/parallel/mesh.py``) on the CPU.

Two gloo ranks (``tests/torch_ddp_cases.py``, spawned once for the file, as ``tests/test_multihost.py`` spawns
its processes; they import no JAX) run every case on their rows of a global batch of 4; this process runs the same
cases on the whole batch, and JAX's step on the batch sharded over a 2-device mesh. The rules, fixed before the
first run:

* KD steps of the tiny ConvTasNet, DPTNet (fused and static) and the Sepformer with ``act_quantizer: mse``, three
  steps through a 3-step observer window: the observers' state after each forward (act ranges and counters, the
  MSE histograms and windows, the static sites' ranges and counter) and after the MSE calibration bit for bit the
  one-process run's, and every rank's whole state bit for bit rank 0's (no buffer broadcast); the loss within
  1e-5 dB; each gradient tensor within 1e-5 of the whole gradient's norm. The one-process run takes the ranks'
  learned parameters before each step: free-running, it would part from them in the last bits at the first update
  (the ranks' gradient is a sum in another order), and the next forward's extremes with them.
* The ConvTasNet step after the window against JAX's value_and_grad on the batch sharded over ``make_mesh(2)``:
  ``tests/test_torch_train_models.py``'s ``ONE_STEP`` rule.
* The power check: a batch whose halves differ by more than 10 dB of SI-SDR. The global loss's gradient meets
  the first rule's bound; DDP's mean of the ranks' own losses (each the log of its own batch means) misses it.
* The speechbrain threshold over the global batch: one rank's rows all below the threshold, the other's above,
  and the step the one-process step by the first rule.
* The dynamic LSTM cell: the 2-rank eval forward bit for bit the one-process forward, a KD step by the first rule.
* Sharded ``ola_infer``: each rank's separation bit for bit the one-process OLA at twice the chunk batch (the same
  blocks).
* One epoch of ``-env asteroid`` and of ``-env tasnet`` through ``python -m fqss_tpu_torch.train`` under
  ``torch.distributed.run`` on 2 ranks against one process: the same history and checkpoint keys, the counters
  equal, the losses within 1e-3 dB and every float tensor of rank 0's checkpoint within 1e-3 of its norm (the runs
  part in the last bits at the first update, and Adam's first steps turn that into up to 2 lr on an element whose
  gradient is near 0).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_ddp_cases as cases
from fqss_tpu.models import ConvTasNet as JaxConvTasNet
from fqss_tpu.parallel.mesh import make_mesh, shard_batch
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.quant.calibration import run_observer
from fqss_tpu_torch.data import synth_batch
from fqss_tpu_torch.data.librimix import LibriMix, batch_iterator, make_mini_librimix
from fqss_tpu_torch.data.musdb import apply_augment, draw_augment
from fqss_tpu_torch.models.convert import convtasnet_from_jax
from fqss_tpu_torch.parallel import mesh as dp
from fqss_tpu_torch.separation.losses import fqss_kd_loss, pit_neg_sisdr_db
from fqss_tpu_torch.train.recipes_music import _rows_of, rows_to_read
from fqss_tpu_torch.train.trainer import TrainConfig
from fqss_tpu_torch.utils.audio import read_audio

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LOSS_DB = 1e-5
TENSOR_OF_WHOLE = 1e-5
ONE_STEP = dict(loss_db=0.01, cos=0.999, whole_rel=0.02, tensor_of_whole=5e-3)  # test_torch_train_models.py
ALGSIMP_OFF = {"xla_disable_hlo_passes": "algsimp"}
POWER_DB = 10.0
CLI_LOSS_DB = 1e-3
CLI_REL = 1e-3


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in dp.ENV + ("LOCAL_RANK", "PYTHONPATH")}
    env.update(PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests")]), OMP_NUM_THREADS="1", **extra)
    return env


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs this file writes for the ranks, the post-window ConvTasNet's JAX variables, and each rank's
    results."""
    out = tmp_path_factory.mktemp("ddp")
    # The post-window ConvTasNet: JAX's init through JAX's observer window, carried across.
    rng = np.random.default_rng(0)
    mix0, _ = synth_batch(rng, cases.BATCH, 2, 1600)
    jm = JaxConvTasNet(q=JaxQuantSpec(observer=True, **cases.SPEC), **cases.CONVTASNET)
    jt = JaxConvTasNet(**cases.CONVTASNET)
    v = jax.device_get(dict(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(mix0))))
    tv = jax.device_get(jax.jit(jt.init)(jax.random.PRNGKey(1), jnp.asarray(mix0)))
    v = jax.device_get(run_observer(jm, v, jnp.asarray(mix0), steps=cases.STEPS + 1))
    torch.save({"student": convtasnet_from_jax(v), "teacher": convtasnet_from_jax(tv)}, out / "post_window.pt")

    # The power batch: rows 0-1 against random sources, rows 2-3 against the student's own estimate plus noise
    # 30 dB down; the threshold between the halves' per-sample losses.
    jax_mix, jax_src = synth_batch(rng, cases.BATCH, 2, 1600)
    power_mix, power_src = map(torch.from_numpy, synth_batch(rng, cases.BATCH, 2, 1600))
    state = cases.load_state(str(out / "post_window.pt"))
    with torch.no_grad():
        est = state.model.eval()(power_mix)[..., :1600]
        noise = torch.from_numpy(np.random.default_rng(3).standard_normal(est.shape).astype(np.float32))
        power_src[2:] = est[2:] + noise[2:] * est[2:].std() * 10 ** (-30 / 20)
        per, _ = fqss_kd_loss(est, state.teacher(power_mix)[..., :1600], power_src, 0.1, per_sample=True)
    threshold = float((per[:2].min() + per[2:].max()) / 2)
    inputs = {"jax_mix": torch.from_numpy(jax_mix), "jax_src": torch.from_numpy(jax_src), "power_mix": power_mix,
              "power_src": power_src, "threshold": torch.tensor(threshold)}
    torch.save(inputs, out / "inputs.pt")

    results = cases.spawn_ranks("torch_ddp_cases.py", out, WORLD, timeout=400)
    return {"dir": out, "jax": (jm, v, tv), "inputs": inputs, "ranks": results}


_ONE_PROCESS: dict = {}


def one_process_kd(ranks, name):
    """The one-process run of KD case ``name`` from rank 0's learned parameters (cached for the file)."""
    if name not in _ONE_PROCESS:
        case = cases.KD_CASES[name]
        _ONE_PROCESS[name] = cases.forced_run(case, ranks["ranks"][0]["kd"][name]["before"], cases.batches(case))
    return _ONE_PROCESS[name]


def assert_bitwise(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys(), what
    for k in want:
        assert torch.equal(got[k], want[k]), f"{what}: {k} {got[k].flatten()[:4]} != {want[k].flatten()[:4]}"


def assert_gradients(got: dict, want: dict, bound: float, what: str) -> None:
    assert got.keys() == want.keys(), what
    whole = torch.cat([g.flatten().double() for g in want.values()]).norm()
    for k in want:
        err = (got[k].double() - want[k].double()).norm()
        assert err <= bound * whole, f"{what}: {k} off by {float(err / whole):.3g} of the whole gradient's norm"


def worst_of_whole(got: dict, want: dict) -> float:
    whole = torch.cat([g.flatten().double() for g in want.values()]).norm()
    return max(float((got[k].double() - want[k].double()).norm() / whole) for k in want)


# ---------------------------------------------------------------------------------------------------------------
# The mesh itself
# ---------------------------------------------------------------------------------------------------------------


def test_rows_of_a_global_batch_and_a_batch_that_does_not_divide():
    mesh = dp.Mesh(1, 2, torch.device("cpu"), "gloo")
    assert mesh.rows(8) == slice(4, 8) and not mesh.is_main
    assert torch.equal(dp.rank_rows(torch.arange(8), mesh), torch.arange(4, 8))
    assert torch.equal(dp.rank_rows(torch.arange(8)), torch.arange(8))  # no process group: one rank
    with pytest.raises(ValueError, match="does not divide over 2 ranks"):
        mesh.rows(3)


def test_init_distributed_without_torchrun_is_one_process(monkeypatch):
    for k in dp.ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(k, raising=False)
    assert dp.init_distributed("cpu") is None
    assert dp.world_size() == 1 and dp.rank() == 0
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="WORLD_SIZE, MASTER_ADDR, MASTER_PORT not"):
        dp.init_distributed("cpu")


def test_helpers_are_the_identity_without_an_active_mesh():
    x = torch.randn(3, 4, requires_grad=True)
    assert dp.active() is None
    mn, mx = dp.extremes(x.min(), x.max())
    assert mn is not None and torch.equal(mn, x.min()) and torch.equal(mx, x.max())
    assert torch.equal(dp.batch_mean(x), x.mean()) and torch.equal(dp.batch_mean(x, dim=(0, 1)), x.mean(dim=(0, 1)))
    assert torch.equal(dp.batch_sum(x), x.sum()) and dp.gather_rows(x, 3) is x and dp.all_agree(False) is False


def test_a_one_rank_group_takes_the_no_group_path_bit_for_bit(monkeypatch):
    """A gloo group of one rank runs every collective (each the identity) and leaves two KD steps bit for bit."""
    case = cases.KD_CASES["ConvTasNet"]
    plain = cases.kd_run(case, None)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(dp.free_port()))
    mesh = dp.init_distributed("cpu")
    try:
        assert mesh == dp.Mesh(0, 1, torch.device("cpu"), "gloo") and dp.world_size() == 1
        grouped = cases.kd_run(case, mesh)
    finally:
        dp.shutdown()
    assert grouped["loss"] == plain["loss"]
    assert_bitwise(grouped["state"], plain["state"], "state")
    for got, want in zip(grouped["grads"], plain["grads"]):
        assert_bitwise(got, want, "gradients")


# ---------------------------------------------------------------------------------------------------------------
# Two ranks against one process
# ---------------------------------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(cases.KD_CASES))
def test_observers_on_two_ranks_equal_one_process_bit_for_bit(ranks, name):
    got, want = ranks["ranks"][0]["kd"][name], one_process_kd(ranks, name)
    assert len(got["observed"]) == len(want["observed"]) == cases.STEPS
    for i, (g, w) in enumerate(zip(got["observed"], want["observed"])):
        assert_bitwise(g, w, f"{name} observers after step {i + 1}'s forward")
    assert got["calibrated"] == want["calibrated"]
    assert_bitwise(got["calibrated_state"], want["calibrated_state"], f"{name} after the calibration")
    if name == "Sepformer-mse":
        assert got["calibrated"] > 0 and all(v.item() for k, v in got["calibrated_state"].items()
                                             if k.endswith(".calibrated"))
    if name == "DPTNet-static":
        sites = [k for k in got["observed"][-1] if k.endswith("site_n_iter")]
        assert sites and all(int(got["observed"][-1][k]) > 0 for k in sites)


@pytest.mark.parametrize("name", list(cases.KD_CASES))
def test_kd_steps_on_two_ranks_meet_the_one_process_losses_and_gradients(ranks, name):
    got, want = ranks["ranks"][0]["kd"][name], one_process_kd(ranks, name)
    assert np.abs(np.subtract(got["loss"], want["loss"])).max() <= LOSS_DB, (got["loss"], want["loss"])
    assert np.abs(np.subtract(got["kd_loss"], want["kd_loss"])).max() <= LOSS_DB
    for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        assert_gradients(g, w, TENSOR_OF_WHOLE, f"{name} step {i + 1}")


@pytest.mark.parametrize("name", list(cases.KD_CASES))
def test_ranks_keep_equal_state_without_a_buffer_broadcast(ranks, name):
    first, second = (r["kd"][name] for r in ranks["ranks"])
    assert first["loss"] == second["loss"]
    assert_bitwise(second["state"], first["state"], f"{name} rank 1 against rank 0")
    assert_bitwise(second["calibrated_state"], first["calibrated_state"], f"{name} calibrated")


def test_two_ranks_meet_jax_on_a_two_device_mesh(ranks):
    """The post-window ConvTasNet step on the ranks against JAX's value_and_grad over the batch sharded on a
    2-device mesh, XLA's algebraic simplifier off (eager JAX's divisions), by ``ONE_STEP``."""
    import optax

    from fqss_tpu.separation.losses import fqss_kd_loss as jax_fqss_kd_loss

    jm, v, tv = ranks["jax"]
    inputs = ranks["inputs"]
    mesh = make_mesh(WORLD)
    mix, src = shard_batch((jnp.asarray(inputs["jax_mix"].numpy()), jnp.asarray(inputs["jax_src"].numpy())), mesh)
    jt = JaxConvTasNet(**cases.CONVTASNET)
    trainable = {"params": v["params"], "qparams": v["qparams"]}

    def loss_fn(trainable, mix, src):
        est, _ = jm.apply({**trainable, "qstats": v["qstats"]}, mix, mutable=["qparams", "qstats"])
        fest = jt.apply(tv, mix)[..., : src.shape[-1]]
        return jax_fqss_kd_loss(est[..., : src.shape[-1]], fest, src, kd_lambda=0.1)[0]

    vg = jax.jit(jax.value_and_grad(loss_fn)).lower(trainable, mix, src).compile(compiler_options=ALGSIMP_OFF)
    want_loss, jgrads = vg(trainable, mix, src)
    clipped = jax.device_get(jax.jit(lambda g: optax.clip_by_global_norm(5.0).update(g, None)[0])(jgrads))
    want = {k: t for k, t in convtasnet_from_jax(clipped).items() if k in ranks["ranks"][0]["jax_step"]["grads"]}
    got = ranks["ranks"][0]["jax_step"]
    assert abs(got["loss"] - float(want_loss)) <= ONE_STEP["loss_db"]
    flat_got = torch.cat([got["grads"][k].flatten().double() for k in want])
    flat_want = torch.cat([want[k].flatten().double() for k in want])
    whole = flat_want.norm()
    assert float(flat_got @ flat_want / (flat_got.norm() * whole)) >= ONE_STEP["cos"]
    assert float((flat_got - flat_want).norm() / whole) <= ONE_STEP["whole_rel"]
    assert_gradients(got["grads"], want, ONE_STEP["tensor_of_whole"], "against JAX's mesh step")


def test_ddp_mean_of_local_losses_misses_the_bound_the_global_loss_meets(ranks):
    inputs = ranks["inputs"]
    state = cases.load_state(str(ranks["dir"] / "post_window.pt"))
    with torch.no_grad():
        est = state.model.eval()(inputs["power_mix"])[..., :1600]
    sisdr = -pit_neg_sisdr_db(est, inputs["power_src"], per_sample=True)
    assert float(sisdr[2:].min() - sisdr[:2].max()) >= POWER_DB, sisdr  # the halves of the batch differ
    want = cases.global_step(state, inputs["power_mix"], inputs["power_src"], TrainConfig(grad_clip=0.0), None)
    assert_gradients(ranks["ranks"][0]["power"]["grads"], want["grads"], TENSOR_OF_WHOLE, "global loss")
    assert abs(ranks["ranks"][0]["power"]["loss"] - want["loss"]) <= LOSS_DB
    miss = worst_of_whole(ranks["ranks"][0]["local_mean"], want["grads"])
    assert miss > TENSOR_OF_WHOLE, f"the mean of the ranks' own losses came within {miss:.3g}"
    assert miss > 100 * worst_of_whole(ranks["ranks"][0]["power"]["grads"], want["grads"])


def test_speechbrain_threshold_selects_over_the_global_batch(ranks):
    inputs = ranks["inputs"]
    th = float(inputs["threshold"])
    cfg = TrainConfig(grad_clip=0.0, threshold_byloss=True, threshold=th)
    state = cases.load_state(str(ranks["dir"] / "post_window.pt"))
    with torch.no_grad():
        est = state.model.eval()(inputs["power_mix"])[..., :1600]
        per, _ = fqss_kd_loss(est, state.teacher(inputs["power_mix"])[..., :1600], inputs["power_src"], 0.1,
                              per_sample=True)
    assert (per[:2] > th).all() and (per[2:] < th).all()  # rank 1 keeps none of its rows, rank 0 both of its
    want = cases.global_step(state, inputs["power_mix"], inputs["power_src"], cfg, None)
    for r in ranks["ranks"]:
        assert abs(r["threshold"]["loss"] - want["loss"]) <= LOSS_DB
        assert_gradients(r["threshold"]["grads"], want["grads"], TENSOR_OF_WHOLE, "threshold")


def test_dynamic_lstm_cell_on_two_ranks_equals_one_process(ranks):
    want = cases.dynamic_forward(None)
    for r in ranks["ranks"]:
        got = r["dynamic"]
        assert torch.equal(got["forward"], want["forward"])
        assert abs(got["loss"] - want["loss"]) <= LOSS_DB
        assert_gradients(got["grads"], want["grads"], TENSOR_OF_WHOLE, "dynamic cell")


def test_sharded_ola_equals_one_process_at_the_same_blocks(ranks):
    state = cases.load_state(str(ranks["dir"] / "post_window.pt"))
    want = cases.sharded_ola(state, None, WORLD * cases.OLA["chunk_batch"])
    assert want.shape == (2, cases.OLA["seconds"]) and np.isfinite(want).all()
    for r in ranks["ranks"]:
        np.testing.assert_array_equal(r["ola"].numpy(), want)


# ---------------------------------------------------------------------------------------------------------------
# The loaders each rank reads
# ---------------------------------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mini_librimix(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("minilibrimix"))
    return make_mini_librimix(root, n_train=8, n_val=4, sample_rate=8000, seconds=0.3)


def test_librimix_crop_read_equals_the_full_read(mini_librimix):
    """The crop is seek-read from the WAV: the samples of the whole file's read, cut, for any crop."""
    train_dir, _ = mini_librimix
    ds = LibriMix(train_dir, sample_rate=8000, n_src=2, segment=0.2, seed=4)
    row = ds.rows[0]
    full = read_audio(row["mixture_path"])[0][0]
    for start, stop in ((0, 1600), (317, 1917), (800, None), (2399, 2400)):
        np.testing.assert_array_equal(ds._read(row["mixture_path"], start, stop), full[start:stop])
    halved = LibriMix(train_dir, sample_rate=8000, n_src=2, segment=0.2, seed=4, resample=0.5)
    assert halved._read(row["mixture_path"], 317, 1917).shape == (800,)


@pytest.mark.parametrize("augmented", [False, True])
def test_ranks_rows_of_librimix_batches_are_the_one_process_batches(mini_librimix, augmented):
    """Each rank reads its rows of every batch and only draws the others' random values: the ranks' rows together
    are the batches one process reads, the augmentations' draws included."""
    train_dir, _ = mini_librimix

    def loader(rows):
        ds = LibriMix(train_dir, sample_rate=8000, n_src=2, segment=0.2, seed=4,
                      augmentation_cfg={"enable": True, "distribution": "uniform", "param0": -5, "param1": 5}
                      if augmented else None, speed_perturb=augmented)
        return list(batch_iterator(ds, 4, seed=2, epoch=1, rows=rows))

    whole = loader(None)
    parts = [loader(dp.Mesh(r, 2, torch.device("cpu"), "gloo").rows(4)) for r in range(2)]
    assert len(whole) == 2
    for b, (mix, src) in enumerate(whole):
        np.testing.assert_array_equal(np.concatenate([p[b][0] for p in parts]), mix)
        np.testing.assert_array_equal(np.concatenate([p[b][1] for p in parts]), src)


@pytest.mark.parametrize("group", [2, 0])
def test_music_augmentation_of_a_ranks_rows_is_the_global_batchs(group):
    """Remix groups inside a rank's rows: the rank reads its rows and applies its slice of the draws; a group of the
    whole batch spans the ranks, so each reads the whole batch. Either way its rows of the augmented global batch."""
    wav = torch.randn(4, 4, 2, 300, generator=torch.Generator().manual_seed(0))
    aug = {"enable": True, "shift": 40, "remix_group_size": group}
    draws = draw_augment(torch.Generator().manual_seed(1), tuple(wav.shape), shift=40, remix_group_size=group)
    whole = apply_augment(wav, **draws, shift=40)
    for r in range(2):
        mesh = dp.Mesh(r, 2, torch.device("cpu"), "gloo")
        reads = rows_to_read(4, mesh, aug)
        assert reads == (mesh.rows(4) if group == 2 else slice(0, 4))
        if reads == mesh.rows(4):
            got = apply_augment(wav[reads], **_rows_of(draws, reads), shift=40)
        else:
            got = apply_augment(wav, **draws, shift=40)[mesh.rows(4)]
        assert torch.equal(got, whole[mesh.rows(4)])
    assert rows_to_read(4, None, aug) == slice(None)


# ---------------------------------------------------------------------------------------------------------------
# The training CLI under torch.distributed.run
# ---------------------------------------------------------------------------------------------------------------


def _speech_conf(work_dir, train_dir, val_dir):
    return {
        "work_dir": str(work_dir),
        "model_cfg": {"name": "ConvTasNet", "model_path": None, "n_src": 2, **{k: v for k, v in
                      cases.CONVTASNET.items() if k != "n_srcs"},
                      "quantization": {"qat": True, "out_quant": True, "n_splitter": 2, "n_combiner": 2,
                                       "observer": True, "max_observations": 2}},
        "dataset_cfg": {"name": "librimix", "task": "sep_clean", "train_dir": train_dir, "valid_dir": val_dir,
                        "sample_rate": 8000, "resample": 1.0, "n_src": 2, "segment": 0.2,
                        "augmentation": {"enable": False}},
        "training_cfg": {"epochs": 1, "batch_size": 4, "half_lr": True, "early_stop": True, "pretrained": None,
                         "seed": 0, "kd_lambda": 0.1, "optim": {"optimizer": "adam", "lr": 0.001}},
        "testing_cfg": {"test_dir": None, "segment_samples": 1200, "overlap": 0.25},
    }


def _music_conf(work_dir, root):
    return {
        "work_dir": str(work_dir),
        "model_cfg": {"name": "ConvTasNetMusic", "sources": ["drums", "bass", "other", "vocals"], "audio_channels": 2,
                      "kernel_size": 20, "stride": 10, "n_filters": 16, "bn_chan": 8, "hid_chan": 16, "n_blocks": 2,
                      "n_repeats": 1, "quantization": {**cases.SPEC, "observer": True}},
        "dataset_cfg": {"name": "musdbhq", "musdb_root": root, "sample_rate": 8000, "segment": 0.5,
                        "data_stride": 0.25, "augmentation": {"enable": True, "shift": 80, "remix_group_size": 0}},
        "training_cfg": {"epochs": 1, "batch_size": 2, "kd_lambda": 0.1, "seed": 0, "optim": {"lr": 1e-3}},
        "testing_cfg": {"segment_samples": 4000, "overlap": 0.25, "NSDR": True},
    }


@pytest.fixture(scope="module")
def mini_musdb(tmp_path_factory):
    from fqss_tpu_torch.data.musdb import make_mini_musdb

    return make_mini_musdb(str(tmp_path_factory.mktemp("musdb")), n_train=3, n_test=1, sample_rate=8000,
                           seconds=1.0)


def _train(conf: dict, env: str, nproc: int, tmp_path) -> dict:
    cfg = tmp_path / f"{env}_{nproc}.json"
    cfg.write_text(json.dumps(conf))
    cli = ["-m", "fqss_tpu_torch.train", "-env", env, "-y", str(cfg), "--device", "cpu"]
    if nproc > 1:
        cli = ["-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={nproc}", *cli]
    proc = subprocess.run([sys.executable, *cli], cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-4000:]
    assert proc.stdout.count("Training done") == 1  # rank 0 alone prints
    work = conf["work_dir"]
    return {"history": json.loads(open(os.path.join(work, "history.json")).read()),
            "ckpt": torch.load(os.path.join(work, "checkpoints", "epoch_0.pt"), weights_only=True)}


@pytest.mark.parametrize("env", ["asteroid", "tasnet"])
def test_train_cli_on_two_ranks_matches_one_process(env, mini_librimix, mini_musdb, tmp_path):
    if env == "asteroid":
        conf = lambda work: _speech_conf(work, *mini_librimix)  # noqa: E731
    else:
        conf = lambda work: _music_conf(work, mini_musdb)  # noqa: E731
    one = _train(conf(tmp_path / "one"), env, 1, tmp_path)
    two = _train(conf(tmp_path / "two"), env, WORLD, tmp_path)
    assert [h.keys() for h in two["history"]] == [h.keys() for h in one["history"]]
    for h2, h1 in zip(two["history"], one["history"]):
        for k in h1:
            assert abs(h2[k] - h1[k]) <= CLI_LOSS_DB, (k, h2[k], h1[k])
    got, want = two["ckpt"]["state"], one["ckpt"]["state"]
    assert got["step"] == want["step"] > 0 and got["skipped"] == want["skipped"] == 0
    assert got["model"].keys() == want["model"].keys()
    for k, w in want["model"].items():
        g = got["model"][k]
        if not w.is_floating_point():
            assert torch.equal(g, w), k
        else:
            assert float((g - w).norm()) <= CLI_REL * max(float(w.norm()), 1e-6), k


def test_val_cli_on_two_ranks_matches_one_process(mini_librimix, tmp_path):
    """``python -m fqss_tpu_torch.val`` under ``torch.distributed.run`` on 2 ranks: each file's OLA sharded over
    the ranks (its few chunks fit one block of 8 chunks and one of 16 alike), the files' scores split between the
    ranks and summed; rank 0 prints the one-process report."""
    train_dir, val_dir = mini_librimix
    work = tmp_path / "trained"
    _train(_speech_conf(work, train_dir, val_dir), "asteroid", 1, tmp_path)
    conf = _speech_conf(work, train_dir, val_dir)
    conf["model_cfg"]["model_path"] = str(work / "best_model.pt")
    conf["testing_cfg"]["test_dir"] = os.path.join(os.path.dirname(train_dir), "test")
    cfg = tmp_path / "val.json"
    cfg.write_text(json.dumps(conf))
    cli = ["-m", "fqss_tpu_torch.val", "-y", str(cfg), "--device", "cpu"]
    runs = [subprocess.run([sys.executable, *pre, *cli], cwd=REPO, env=_env(), capture_output=True, text=True,
                           timeout=300)
            for pre in ([], ["-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={WORLD}"])]
    for proc in runs:
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-4000:]
    # the last line is the report (one process also prints a running mean after its second file)
    reports = [[line for line in proc.stdout.splitlines() if line.startswith("SI-SDR=")] for proc in runs]
    assert len(reports[1]) == 1 and reports[1][-1] == reports[0][-1], reports
