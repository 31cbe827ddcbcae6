"""Checkpoint import: reference PyTorch checkpoints and the JAX package's ``.npz`` exports into the port's five models.

Tiny models of each family (ConvTasNet, DPTNet, the Sepformer, ConvTasNet-music, HTDemucs) take the port's seeded
init; the QAT ones are calibrated by the port's observer steps. Every check is exact (``torch.equal``):

* the reference-keyed float state dict that ``chip_smoke.py:reference_state_dict`` writes (an inverse of the JAX
  package's key map) is held to JAX itself: JAX's ``*_params_from_torch`` reads every key of it and gives back the
  JAX params of the same weights (their tree taken from JAX's own ``init``, traced, not compiled: ``to_jax``);
* the port's float import (``models/convert.py:*_params_from_torch``) equals JAX's converter followed by
  ``*_from_jax``; through the factory (a ``.pth`` wrapped in ``state_dict``, with ``model.`` prefixes and an
  ``fmodel.`` key), the teacher of ``create_model_and_teacher`` is the source float model and the student holds its
  shared weights, the encoder widened;
* the port's QAT import (``*_qat_from_torch``) equals JAX's followed by ``*_from_jax``, on a reference post-surgery
  state dict written by :data:`QAT_REFERENCE_KEYS` (read whole by JAX);
* the JAX package's ``export_model`` ``.npz`` of the same variables, loaded by ``create_pretrained_model``, equals
  ``*_from_jax`` of them; the port's ``*_to_jax`` writes that file's keys and arrays back;
* ConvTasNet's teacher forward against JAX's ``create_model_and_teacher`` on the same ``.pth`` (SNR >= 100 dB, the
  float models' bound of ``chip_smoke.py`` phase 26); the student's shared weights equal; its QAT-only entries
  (quantizer ranges and counters, the combiner's residual block) and the widened encoder's LSB planes keep each
  package's own init, so they are not compared;
* an export taken inside an MSE observer window, calibrated on import to the ranges JAX's ``create_pretrained_model``
  gives; the refusals (an orbax directory, a file that holds pickled objects), JAX's message for a missing ``.npz``
  key, and the port's own ``.pt``;
* the merge of a float teacher into HTDemucs's splitter-widened 2-D frequency encoder;
* the CLIs' keys: ``-env asteroid`` from a reference ``.pth`` as ``training_cfg.pretrained`` (its teacher the
  source model), ``infer`` and ``val`` on a JAX ``.npz`` as ``model_cfg.model_path`` (the same bytes and scores as
  the run's own ``best_model.pt``).
"""

import json
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from fqss_tpu.models import convert as jax_convert
from fqss_tpu.models import factory as jax_factory
from fqss_tpu.quant import QuantSpec as JaxQuantSpec
from fqss_tpu.train.checkpoints import export_model, restore_variables
from fqss_tpu_torch.models import convert
from fqss_tpu_torch.models.factory import (create_model, create_model_and_teacher, create_pretrained_model,
                                           merge_float_params, quant_spec_from_cfg)
from fqss_tpu_torch.quant.spec import QuantSpec
from fqss_tpu_torch.train.checkpoints import jax_export_entries

torch.set_num_threads(1)

SPEC = dict(qat=True, n_splitter=2, n_combiner=2, out_quant=True, max_observations=3)
QUANT = {**SPEC, "observer": True}
CFGS = {
    "ConvTasNet": dict(name="ConvTasNet", n_src=2, kernel_size=16, stride=8, n_filters=16, bn_chan=8, hid_chan=16,
                       n_blocks=2, n_repeats=2),
    "DPTNet": dict(name="DPTNet", n_src=2, enc_dim=16, feature_dim=8, hidden_dim=16, layer=2, segment_size=20),
    "Sepformer": dict(name="Sepformer", n_src=2, n_filters=32, n_heads=4, n_repeats=2, n_layers=2, chunk_size=20,
                      n_ffn=48),
    "ConvTasNetMusic": dict(name="ConvTasNetMusic", n_filters=16, bn_chan=8, hid_chan=16, n_blocks=2, n_repeats=2),
    "HTDemucs": dict(name="HTDemucs", channels=8, nfft=512, t_layers=2, t_heads=4, segment=0.5, samplerate=8000),
}
MUSIC = ("ConvTasNetMusic", "HTDemucs")
T = 2000
OBSERVE_STEPS = 4


def _depth(name, model):
    """The depth arguments of the family's converters (``fqss_tpu/models/factory.py:_torch_to_params``)."""
    return {"ConvTasNet": lambda: dict(n_repeats=model.n_repeats, n_blocks=model.n_blocks),
            "DPTNet": lambda: dict(layer=model.layer),
            "Sepformer": lambda: dict(n_repeats=model.n_repeats, n_layers=model.n_layers),
            "ConvTasNetMusic": lambda: dict(n_repeats=model.n_repeats, n_blocks=model.n_blocks),
            "HTDemucs": lambda: dict(depth=model.depth, t_layers=model.t_layers, dconv_depth=model.dconv_depth)}[name]()


_SNAKE = {"ConvTasNet": "convtasnet", "DPTNet": "dptnet", "Sepformer": "sepformer",
          "ConvTasNetMusic": "convtasnet_music", "HTDemucs": "htdemucs"}


def _fn(module, name, suffix):
    return getattr(module, f"{_SNAKE[name]}_{suffix}")


def _mixture(name, batch=2):
    rng = np.random.default_rng(0)
    shape = (batch, 2, T) if name in MUSIC else (batch, T)
    return (0.3 * rng.standard_normal(shape)).astype(np.float32)


def _cfg(name, qat=True):
    return {**CFGS[name], "quantization": QUANT} if qat else dict(CFGS[name])


def _port(name, qat=True, seed=0):
    """The port's model of the family at the seeded init; a QAT one after OBSERVE_STEPS observer steps in
    ``train()`` mode (ranges and counters off their init)."""
    model = create_model(_cfg(name, qat), quant_spec_from_cfg(_cfg(name, qat)) if qat else QuantSpec(),
                         generator=torch.Generator().manual_seed(seed))
    if qat:
        with torch.no_grad():
            for _ in range(OBSERVE_STEPS):
                model.train()(torch.from_numpy(_mixture(name)))
    return model.eval()


def to_jax(name, port, q):
    """JAX's variables of the family's model under ``q`` holding ``port``'s state: ``*_from_jax`` run on a tree of
    element indices places each port tensor in JAX's leaves, whose tree comes from JAX's ``init`` (traced, not
    compiled)."""
    jm = jax_factory.create_model(_cfg(name), q)
    x = jnp.asarray(_mixture(name))
    kw = {"train": True} if name == "HTDemucs" else {}
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, **kw), x)
    shapes = {k: v for k, v in shapes.items() if k != "macs"}
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    sizes = np.cumsum([0] + [leaf.size for leaf in leaves])
    index = jax.tree_util.tree_unflatten(tree, [np.arange(a, b).reshape(leaf.shape)
                                                for a, b, leaf in zip(sizes[:-1], sizes[1:], leaves)])
    flat = np.zeros(sizes[-1])
    state = port.state_dict()
    places = _fn(convert, name, "from_jax")(index)
    assert places.keys() == state.keys()
    for key, place in places.items():
        flat[place.numpy().ravel()] = state[key].double().numpy().ravel()
    return jax.tree_util.tree_unflatten(tree, [flat[a:b].reshape(leaf.shape).astype(leaf.dtype)
                                               for a, b, leaf in zip(sizes[:-1], sizes[1:], leaves)])


class Recorder(dict):
    """A state dict that records which keys were read."""

    def __init__(self, *args):
        super().__init__(*args)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) and isinstance(want, dict), path
    assert got.keys() == want.keys(), (path, sorted(set(got) ^ set(want)))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            assert np.asarray(got[k]).shape == np.asarray(want[k]).shape, f"{path}/{k}"
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=f"{path}/{k}")


def _assert_states_equal(got, want):
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# Reference float checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CFGS))
def test_reference_state_dict_is_held_to_jax(name):
    teacher = _port(name, qat=False)
    ref = Recorder(_numpy(chip_smoke.reference_state_dict(name, teacher)))
    params = _fn(jax_convert, name, "params_from_torch")(ref, **_depth(name, teacher))
    assert ref.read == set(ref), sorted(set(ref) - ref.read)
    _assert_trees_equal(params, to_jax(name, teacher, JaxQuantSpec())["params"])


@pytest.mark.parametrize("name", list(CFGS))
def test_float_import_equals_jax_converter(name):
    teacher = _port(name, qat=False)
    ref = _numpy(chip_smoke.reference_state_dict(name, teacher))
    got = _fn(convert, name, "params_from_torch")(ref, **_depth(name, teacher))
    want = _fn(convert, name, "from_jax")({"params": _fn(jax_convert, name, "params_from_torch")(ref, **_depth(name,
                                                                                                          teacher))})
    _assert_states_equal(got, want)
    _assert_states_equal(got, teacher.state_dict())


def _write_reference(path, name, teacher):
    """A reference float checkpoint as a KD run saves one: wrapped in ``state_dict``, every key under ``model.``,
    with a stray ``fmodel.`` (teacher) key."""
    ref = chip_smoke.reference_state_dict(name, teacher)
    torch.save({"state_dict": {**{f"model.{k}": v for k, v in ref.items()},
                               "fmodel.encoder.weight": torch.zeros(3)}}, path)


@pytest.mark.parametrize("name", list(CFGS))
def test_factory_takes_a_reference_pth(name, tmp_path):
    source = _port(name, qat=False, seed=7)
    path = tmp_path / "model.pth"
    _write_reference(path, name, source)
    student, teacher = create_model_and_teacher(_cfg(name), str(path), generator=torch.Generator().manual_seed(0))
    _assert_states_equal(teacher.state_dict(), source.state_dict())
    served = create_pretrained_model({**_cfg(name), "model_path": str(path)}, observer=False)
    for model in (student, served):
        state = model.state_dict()
        for k, v in source.state_dict().items():
            if state[k].shape == v.shape:
                assert torch.equal(state[k], v), k
            else:  # the splitter-widened encoder: its MSB plane is the float kernel
                assert torch.equal(state[k][:, : v.shape[1]], v), k


# ---------------------------------------------------------------------------
# Reference QAT checkpoints (post-surgery state dicts with learned ranges)
# ---------------------------------------------------------------------------

# The reference's post-surgery key names, read backwards from fqss_tpu/models/convert.py:*_qat_from_torch: rules that
# rename a key of the port's QAT state dict into the reference's, applied in turn (re.sub). The counters (n_iter,
# observed) are the port's and JAX's own state, not the reference's.
_TCN = (r"^masker\.tcn_(\d+)_(\d+)\.", lambda m, model: f"masker.TCN.{int(m[1]) * model.n_blocks + int(m[2])}.")
_MHA = [(r"\.(self_attn|cross_attn|mha)\.in_proj_(weight|bias)$", r".\1.mha.in_proj_\2"),
        (r"\.(self_attn|cross_attn|mha)\.out_proj_(weight|bias)$", r".\1.mha.out_proj.\2")]
QAT_REFERENCE_KEYS = {
    "ConvTasNet": [
        _TCN, (r"^masker\.skip_add_(\d+)\.", r"masker.adds.\1."),
        (r"\.conv_in\.", ".shared_block.0."), (r"\.norm_in\.", ".shared_block.2."),
        (r"\.conv_dw\.", ".shared_block.3."), (r"\.norm_dw\.", ".shared_block.5."),
        (r"^masker\.bottleneck_norm\.", "masker.bottleneck.0."),
        (r"^masker\.bottleneck_conv\.", "masker.bottleneck.1."),
        (r"^masker\.mask_prelu\.", "masker.mask_net.0."), (r"^masker\.mask_conv\.", "masker.mask_net.1."),
        (r"^encoder\.conv\.weight$", "encoder.conv1d.weight"), (r"^encoder\.conv\.", "encoder."),
        (r"^decoder\.weight$", "decoder.convTr1d.weight"),
        (r"\.residual_encoder\.weight_fake_quantize\.", ".weight_fake_quantize."),
        (r"\.nl\.alpha$", ".nl.weight"), (r"\.norm\.(weight|bias)$", r".groupnorm.\1"),
        (r"^(masker\.(?:bottleneck\.1|TCN\.\d+\.(?:shared_block\.[03]|res_conv|skip_conv)|mask_net\.1))"
         r"\.(weight|bias)$", r"\1.conv1d.\2"),
    ],
    "DPTNet": [
        (r"^separator\.DPT\.(row|col)_(\d+)\.", r"separator.DPT.\1_transformer.\2.transformer."), *_MHA,
        (r"\.lstm\.fw\.w_(ih|hh)$", r".lstm.lstm.weight_\1_l0"),
        (r"\.lstm\.bw\.w_(ih|hh)$", r".lstm.lstm.weight_\1_l0_reverse"),
        (r"\.lstm\.fw\.b_(ih|hh)$", r".lstm.lstm.bias_\1_l0"),
        (r"\.lstm\.bw\.b_(ih|hh)$", r".lstm.lstm.bias_\1_l0_reverse"),
        (r"\.lstm\.fw\.wq_(ih|hh)\.", r".lstm.weight_quantizers_dict.weight_\1_l0."),
        (r"\.lstm\.bw\.wq_(ih|hh)\.", r".lstm.weight_quantizers_dict.weight_\1_l0_reverse."),
        (r"\.linear\.(weight|bias)$", r".linear.linear.\1"),
        (r"^enc_LN\.norm\.", "enc_LN.groupnorm."), (r"\.norm\.(weight|bias)$", r".layernorm.\1"),
        (r"^separator\.DPT\.out_prelu\.nl\.alpha$", "separator.DPT.output.0.nl.weight"),
        (r"^separator\.DPT\.out_prelu\.", "separator.DPT.output.0."),
        (r"^separator\.DPT\.out_conv\.(weight|bias)$", r"separator.DPT.output.1.conv2d.\1"),
        (r"^separator\.DPT\.out_conv\.", "separator.DPT.output.1."),
        (r"^separator\.(output|output_gate)\.", r"separator.\1.0."),
        (r"^separator\.(output|output_gate)\.0\.(weight|bias)$", r"separator.\1.0.conv1d.\2"),
        (r"^(encoder\.conv|separator\.BN|mask_conv1x1)\.weight$", r"\1.conv1d.weight"),
        (r"^encoder\.conv\.", "encoder.conv1d_U."), (r"^mask_conv1x1\.", "mask_conv1x1.0."),
        (r"^decoder\.", "decoder.basis_signals."),
        (r"^decoder\.basis_signals\.weight$", "decoder.basis_signals.linear.weight"),
        (r"\.residual_encoder_weight$", ".residual_encoder.weight"),
    ],
    "Sepformer": [
        (r"^masker\.dp_(\d+)\.", r"masker.layers.\1."), (r"\.layer_(\d+)\.", r".layers.\1."), *_MHA,
        (r"\.ffn_in\.", ".ffn.0."), (r"\.ffn_out\.", ".ffn.3."), (r"\.ffn_relu\.", ".ffn.1."),
        (r"\.pos_const\.", ".pos.const."), (r"\.ffn\.([03])\.(weight|bias)$", r".ffn.\1.linear.\2"),
        (r"^masker\.(norm|layers\.\d+\.(intra|inter)_norm)\.norm\.", r"masker.\1.groupnorm."),
        (r"\.norm\.(weight|bias)$", r".layernorm.\1"),
        (r"^masker\.prelu\.nl\.alpha$", "masker.prelu.nl.weight"),
        (r"^masker\.conv2d\.(weight|bias)$", r"masker.conv2d.conv2d.\1"),
        (r"^masker\.(net_out|net_gate|end_conv)\.", r"masker.\1.0."),
        (r"^(encoder\.conv|masker\.conv1d|masker\.(?:net_out|net_gate|end_conv)\.0)\.(weight|bias)$", r"\1.conv1d.\2"),
        (r"^encoder\.conv\.", "encoder.0."),
        (r"^decoder\.weight$", "decoder.convTr1d.weight"),
        (r"\.residual_encoder\.weight_fake_quantize\.", ".weight_fake_quantize."),
        (r"\.residual_decoder_weight$", ".residual_decoder.weight"),
    ],
    "ConvTasNetMusic": [
        (r"^separator\.layer_norm\.", "separator.network.0.norm."),
        (r"^separator\.network\.0\.norm\.norm\.", "separator.network.0.norm.layernorm."),
        (r"^separator\.bottleneck\.", "separator.network.1."), (r"^separator\.mask_conv\.", "separator.network.3."),
        (r"^separator\.tcn_(\d+)_(\d+)\.", r"separator.network.2.\1.\2."),
        (r"\.conv1x1\.", ".net.0."), (r"\.dsconv\.depthwise\.", ".net.3.net.0."),
        (r"\.dsconv\.norm\.", ".net.3.net.2."),
        (r"\.dsconv\.pointwise\.", ".net.3.net.3."),
        (r"^(separator\.network\.2\.\d+\.\d+)\.norm\.", r"\1.net.2."),
        (r"\.norm\.(weight|bias)$", r".groupnorm.\1"), (r"\.nl\.alpha$", ".nl.weight"),
        (r"^(encoder\.conv|separator\.network\.(?:[13]|2\.\d+\.\d+\.net\.(?:0|3\.net\.[03])))\.(weight|bias)$",
         r"\1.conv1d.\2"),
        (r"^encoder\.conv\.", "encoder.0."),
        (r"^decoder\.weight$", "decoder.linear.weight"),
        (r"\.residual_encoder_weight$", ".residual_encoder.weight"),
    ],
    "HTDemucs": [
        (r"^(encoder|tencoder|decoder|tdecoder)_(\d+)\.", r"\1.\2."),
        (r"\.dconv\.layer_(\d+)_conv\.", r".dconv.layers.\1.0."),
        (r"\.dconv\.layer_(\d+)_mix\.", r".dconv.layers.\1.3."),
        (r"\.dconv\.layer_(\d+)_scale\.", r".dconv.layers.\1.6."), (r"\.dconv\.add_(\d+)\.", r".dconv.adds.\1."),
        (r"\.dconv\.layers\.(\d+)\.([03])\.norm\.", r".dconv.layers.\1.\2.gn."),
        (r"\.dconv\.layers\.(\d+)\.([03])\.(weight|bias)$", r".dconv.layers.\1.\2.conv1d.\3"),
        (r"^(encoder|decoder)\.(\d+)\.(conv|rewrite)\.(weight|bias)$", r"\1.\2.\3.conv2d.\4"),
        (r"^(tencoder|tdecoder)\.(\d+)\.(conv|rewrite)\.(weight|bias)$", r"\1.\2.\3.conv1d.\4"),
        (r"^decoder\.(\d+)\.conv_tr\.(weight|bias)$", r"decoder.\1.conv_tr.convTr2d.\2"),
        (r"^tdecoder\.(\d+)\.conv_tr\.(weight|bias)$", r"tdecoder.\1.conv_tr.convTr1d.\2"),
        (r"\.residual_encoder\.weight_fake_quantize\.", ".weight_fake_quantize."),
        (r"\.residual_decoder_(weight|bias)$", r".residual_decoder.\1"),
        (r"^freq_emb\.embedding$", "freq_emb.embedding.embedding.weight"),
        (r"^freq_emb\.(weight|activation)_fake_quantize\.", r"freq_emb.embedding.\1_fake_quantize."),
        (r"^crosstransformer\.layer_t_(\d+)\.", r"crosstransformer.layers_t.\1."),
        (r"^crosstransformer\.layer_(\d+)\.", r"crosstransformer.layers.\1."), *_MHA,
        (r"\.norm_out\.norm\.", ".norm_out."), (r"\.norm\.(weight|bias)$", r".layernorm.\1"),
        (r"\.(linear[12])\.(weight|bias)$", r".\1.linear.\2"),
    ],
}
QAT_REFERENCE_LAYOUT = [  # (reference key, the tensor in the reference's layout)
    (r"\.lstm\.lstm\.weight_(ih|hh)_l0(_reverse)?$", lambda v: v.T),
    (r"\.weight_quantizers_dict\.weight_(ih|hh)_l0(_reverse)?\.(min|max)_range$", lambda v: v.T),
    (r"^(separator\.DPT\.output\.1|masker\.conv2d)\.(conv2d\.weight|weight_fake_quantize\.(min|max)_range)$",
     lambda v: v[:, :, None, None]),
]


def qat_reference_state_dict(name, model):
    """The reference post-surgery QAT state dict of the port's QAT ``model`` of family ``name``."""
    out = {}
    for key, v in model.state_dict().items():
        if key.rsplit(".", 1)[-1] in ("n_iter", "observed"):
            continue
        for pattern, repl in QAT_REFERENCE_KEYS[name]:
            key = re.sub(pattern, (lambda m, r=repl: r(m, model)) if callable(repl) else repl, key)
        for pattern, layout in QAT_REFERENCE_LAYOUT:
            if re.search(pattern, key):
                v = layout(v)
        out[key] = v.numpy().copy()
    return out


@pytest.mark.parametrize("name", list(CFGS))
def test_qat_import_equals_jax_converter(name):
    model = _port(name)
    ref = Recorder(qat_reference_state_dict(name, model))
    depth = {**_depth(name, model), "n_combiner": 2}
    params, qparams = _fn(jax_convert, name, "qat_from_torch")(ref, **depth)
    assert ref.read == set(ref), sorted(set(ref) - ref.read)
    got = _fn(convert, name, "qat_from_torch")(dict(ref), **depth)
    _assert_states_equal(got, _fn(convert, name, "from_jax")({"params": params, "qparams": qparams}))
    # what it gives is the model's weights and ranges: everything but the counters
    state = model.state_dict()
    assert set(state) - set(got) == {k for k in state if k.rsplit(".", 1)[-1] in ("n_iter", "observed")}
    _assert_states_equal(got, {k: state[k] for k in got})


# ---------------------------------------------------------------------------
# The JAX package's .npz exports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CFGS))
def test_jax_npz_export_loads_and_writes_back(name, tmp_path):
    model = _port(name)
    variables = to_jax(name, model, JaxQuantSpec(**QUANT))
    path = str(tmp_path / "model.npz")
    export_model(path, variables)
    loaded = create_pretrained_model({**_cfg(name), "model_path": path}, observer=False)
    _assert_states_equal(loaded.state_dict(), _fn(convert, name, "from_jax")(jax.device_get(variables)))
    # the port's inverse writes the same file back: keys, values and dtypes
    with np.load(path) as f:
        want = {k: f[k] for k in f.files}
    got = jax_export_entries(_fn(convert, name, "to_jax")(loaded.state_dict()))
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def convtasnet_npz(tmp_path_factory):
    """(the ConvTasNet QAT model, the JAX export of its variables)."""
    model = _port("ConvTasNet")
    path = str(tmp_path_factory.mktemp("npz") / "model.npz")
    export_model(path, to_jax("ConvTasNet", model, JaxQuantSpec(**QUANT)))
    return model, path


def test_missing_npz_key_raises_jaxs_message(convtasnet_npz, tmp_path):
    model, path = convtasnet_npz
    with np.load(path) as f:
        entries = {k: f[k] for k in f.files}
    gone = "qparams/masker/tcn_1_0/conv_dw/weight_fake_quantize/max_range"
    del entries[gone]
    cut = str(tmp_path / "cut.npz")
    np.savez(cut, **entries)
    template = to_jax("ConvTasNet", model, JaxQuantSpec(**QUANT))
    with pytest.raises(ValueError, match=f"^Missing key in checkpoint: {gone}$") as want:
        restore_variables(cut, template)
    with pytest.raises(ValueError) as got:
        create_pretrained_model({**_cfg("ConvTasNet"), "model_path": cut})
    assert str(got.value) == str(want.value)


def test_pending_mse_export_and_orbax_directory_are_refused(tmp_path):
    """An export taken inside an MSE observer window loads, and its histograms are calibrated on import to the ranges
    that JAX's ``create_pretrained_model`` gives (``fqss_tpu/models/factory.py:187-195``); an orbax directory stays
    refused."""
    cfg = {**CFGS["ConvTasNet"], "quantization": {**QUANT, "act_quantizer": "mse"}}
    model = create_model(cfg, quant_spec_from_cfg(cfg), generator=torch.Generator().manual_seed(0))
    mix = _mixture("ConvTasNet")
    with torch.no_grad():
        for k in range(OBSERVE_STEPS - 1):  # the window (3) is full, nothing is calibrated yet
            model.train()(torch.from_numpy(mix * (1 + 0.2 * k)))
    pending = str(tmp_path / "pending.npz")
    export_model(pending, convert.convtasnet_to_jax(model.state_dict()))
    _, want = jax_factory.create_pretrained_model({**cfg, "model_path": pending}, jnp.asarray(mix))
    got = convert.convtasnet_to_jax(create_pretrained_model({**cfg, "model_path": pending}).state_dict())
    flags = []
    for coll in ("qparams", "qstats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(want[coll]))[0]:
            node = got[coll]
            for k in path:
                node = node[k.key]
            np.testing.assert_array_equal(node, np.asarray(leaf), err_msg=jax.tree_util.keystr(path))
            if path[-1].key == "calibrated":
                flags.append(bool(leaf))
    assert flags and all(flags)
    orbax = tmp_path / "checkpoints" / "3"
    orbax.mkdir(parents=True)
    with pytest.raises(ValueError, match=f"{re.escape(str(orbax))}: an orbax checkpoint directory"):
        create_pretrained_model({**_cfg("ConvTasNet"), "model_path": str(orbax)})


class _Pickled:
    pass


def test_pickled_objects_are_refused_and_the_ports_own_pt_loads(tmp_path):
    model = _port("Sepformer")
    own = tmp_path / "best_model.pt"
    torch.save(model.state_dict(), own)
    _assert_states_equal(create_pretrained_model({**_cfg("Sepformer"), "model_path": str(own)}).state_dict(),
                         model.state_dict())
    bad = tmp_path / "with_objects.pth"
    torch.save({"state_dict": model.state_dict(), "args": _Pickled()}, bad)
    with pytest.raises(ValueError, match=f"{re.escape(str(bad))}: refused: .*objects other than tensors"):
        create_pretrained_model({**_cfg("Sepformer"), "model_path": str(bad)})
    with pytest.raises(ValueError, match="lacks the key"):  # a state dict of another family
        create_model_and_teacher(_cfg("DPTNet"), str(own))


# ---------------------------------------------------------------------------
# ConvTasNet against JAX's factory on the same .pth
# ---------------------------------------------------------------------------


def test_convtasnet_pretrained_against_jax_factory(tmp_path):
    source = _port("ConvTasNet", qat=False, seed=7)
    path = tmp_path / "convtasnet.pth"
    _write_reference(path, "ConvTasNet", source)
    mix = _mixture("ConvTasNet")
    cfg = _cfg("ConvTasNet")
    _, qvars, jax_teacher, tparams = jax_factory.create_model_and_teacher(cfg, str(path), jnp.asarray(mix))
    student, teacher = create_model_and_teacher(cfg, str(path), generator=torch.Generator().manual_seed(0))
    want = np.asarray(jax.jit(jax_teacher.apply)({"params": tparams}, jnp.asarray(mix)))
    with torch.no_grad():
        got = teacher(torch.from_numpy(mix)).numpy()
    snr = 10 * np.log10(np.sum(want**2, -1) / np.maximum(np.sum((want - got) ** 2, -1), 1e-30))
    assert (snr >= 100).all(), snr
    jax_student = convert.convtasnet_from_jax(jax.device_get(qvars))
    state = student.state_dict()
    for k, v in source.state_dict().items():  # the shared weights; the widened encoder's MSB plane
        got, want = state[k], jax_student[k]
        if got.shape != v.shape:
            got, want = got[:, : v.shape[1]], want[:, : v.shape[1]]
        assert torch.equal(got, v) and torch.equal(want, v), k


# ---------------------------------------------------------------------------
# The merge repair: HTDemucs's 2-D frequency encoder
# ---------------------------------------------------------------------------


def test_htdemucs_teacher_widens_the_2d_frequency_encoder(tmp_path):
    source = _port("HTDemucs", qat=False, seed=3)
    path = tmp_path / "teacher.pt"
    torch.save(source.state_dict(), path)
    student, teacher = create_model_and_teacher(_cfg("HTDemucs"), str(path), generator=torch.Generator().manual_seed(0))
    w, fw = student.state_dict()["encoder_0.conv.weight"], source.state_dict()["encoder_0.conv.weight"]
    assert fw.ndim == 4 and w.shape == (fw.shape[0], 2 * fw.shape[1], *fw.shape[2:])
    assert torch.equal(w[:, : fw.shape[1]], fw)
    _assert_states_equal(teacher.state_dict(), source.state_dict())
    merged = merge_float_params(student.state_dict(), source.state_dict(), 2, lsb_init="zeros")
    assert torch.equal(merged["encoder_0.conv.weight"], torch.cat([fw, torch.zeros_like(fw)], dim=1))


# ---------------------------------------------------------------------------
# The CLIs' keys: training_cfg.pretrained, model_cfg.model_path
# ---------------------------------------------------------------------------


def test_train_infer_and_val_take_imported_checkpoints(tmp_path):
    """``-env asteroid`` from a reference ``.pth`` as ``training_cfg.pretrained``; ``infer`` and ``val`` on a JAX
    ``.npz`` export of the run's best model as ``model_cfg.model_path``, equal to the run's own ``best_model.pt``."""
    from fqss_tpu_torch import infer, val
    from fqss_tpu_torch.data.librimix import make_mini_librimix
    from fqss_tpu_torch.train.recipes import train_speech

    train_dir, val_dir = make_mini_librimix(str(tmp_path / "mini"), n_train=2, n_val=2, seconds=0.3)
    source = _port("ConvTasNet", qat=False, seed=7)
    pretrained = tmp_path / "teacher.pth"
    _write_reference(pretrained, "ConvTasNet", source)
    work = tmp_path / "run"
    conf = {"work_dir": str(work), "model_cfg": {**_cfg("ConvTasNet"), "model_path": None},
            "dataset_cfg": {"name": "librimix", "task": "sep_clean", "train_dir": train_dir, "valid_dir": val_dir,
                            "sample_rate": 8000, "resample": 1.0, "n_src": 2, "segment": 0.3,
                            "augmentation": {"enable": False}},
            "training_cfg": {"epochs": 1, "batch_size": 2, "pretrained": str(pretrained), "seed": 0,
                             "kd_lambda": 0.1, "optim": {"optimizer": "adam", "lr": 0.001, "weight_decay": 0.0}},
            "testing_cfg": {"test_dir": str(tmp_path / "mini" / "test"), "segment_samples": 1200, "overlap": 0.25}}
    result = train_speech(conf, "asteroid", device="cpu")
    _assert_states_equal(result["state"].teacher.state_dict(), source.state_dict())

    best = create_pretrained_model({**_cfg("ConvTasNet"), "model_path": str(work / "best_model.pt")})
    npz = tmp_path / "best.npz"
    export_model(str(npz), to_jax("ConvTasNet", best, JaxQuantSpec(**QUANT)))
    wav = next((tmp_path / "mini" / "test" / "mix_clean").iterdir())
    outs, scores = {}, {}
    for name, path in (("pt", work / "best_model.pt"), ("npz", npz)):
        run_conf = {**conf, "model_cfg": {**conf["model_cfg"], "model_path": str(path)}}
        cfg_path = tmp_path / f"{name}.json"
        cfg_path.write_text(json.dumps(run_conf))
        infer.main(["-y", str(cfg_path), "-a", str(wav), "-o", str(tmp_path / name), "--device", "cpu"])
        outs[name] = [(tmp_path / name / f"source_{s}.wav").read_bytes() for s in (1, 2)]
        scores[name] = val.evaluate(run_conf, device="cpu", limit=1, compute_stoi=False)
    assert outs["npz"] == outs["pt"]
    scores = {k: {m: v for m, v in got.items() if m != "stoi"} for k, got in scores.items()}  # not computed: nan
    assert scores["npz"] == scores["pt"] and np.isfinite(list(scores["npz"].values())).all()
