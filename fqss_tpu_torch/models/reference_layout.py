"""The reference checkpoints' layout: reference PyTorch state dicts -> JAX-layout parameter trees.

A copy of ``fqss_tpu/models/convert.py`` (numpy only), kept here because the
port imports nothing of the JAX package. Each ``*_params_from_torch`` maps a
reference float state dict, and each ``*_qat_from_torch`` a reference
post-surgery QAT state dict with its learned ranges, as flat ``{name:
np.ndarray}`` dicts, onto the nested ``params`` (and ``qparams``) trees of
the JAX package's models: the layout that ``models/convert.py:*_from_jax``
takes. ``models/convert.py`` composes the two, so that one set of layout
rules serves both bridges.

Layout transforms:
* Conv1d   [Co, Ci, k]  -> (k, Ci, Co)
* ConvT1d  [Ci, Co, k]  -> (k, Ci, Co)
* Conv2d   [Co, Ci, kh, kw] -> (kh, kw, Ci, Co)
* Linear   [out, in]    -> (in, out)
* GroupNorm/LayerNorm weight -> scale
* PReLU weight -> alpha
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


def conv1d_w(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def convt1d_w(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 0, 1)))


def conv2d_w(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def convt2d_w(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 0, 1)))


def linear_w(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w))


def _conv(sd: Mapping[str, np.ndarray], prefix: str, bias: bool = True) -> dict:
    out = {"kernel": conv1d_w(sd[f"{prefix}.weight"])}
    if bias and f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return out


def _norm(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {"norm": {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}}


def convtasnet_params_from_torch(sd: Mapping[str, np.ndarray], n_repeats: int = 3, n_blocks: int = 8) -> dict:
    """Map a reference float ConvTasNetQ state_dict (convtasnetq.py:118-288)
    onto the flax param tree of :class:`fqss_tpu.models.convtasnet.ConvTasNet`."""
    params: dict = {}
    params["encoder"] = {"conv": {"kernel": conv1d_w(sd["encoder.weight"])}}
    masker: dict = {
        "bottleneck_norm": _norm(sd, "masker.bottleneck.0"),
        "bottleneck_conv": _conv(sd, "masker.bottleneck.1"),
        "mask_prelu": {"nl": {"alpha": sd["masker.mask_net.0.weight"]}},
        "mask_conv": _conv(sd, "masker.mask_net.1"),
    }
    idx = 0
    for s in range(n_repeats):
        for layer in range(n_blocks):
            p = f"masker.TCN.{idx}"
            masker[f"tcn_{s}_{layer}"] = {
                "conv_in": {**_conv(sd, f"{p}.shared_block.0"), "nl": {"alpha": sd[f"{p}.shared_block.1.weight"]}},
                "norm_in": _norm(sd, f"{p}.shared_block.2"),
                "conv_dw": {**_conv(sd, f"{p}.shared_block.3"), "nl": {"alpha": sd[f"{p}.shared_block.4.weight"]}},
                "norm_dw": _norm(sd, f"{p}.shared_block.5"),
                "res_conv": _conv(sd, f"{p}.res_conv"),
                "skip_conv": _conv(sd, f"{p}.skip_conv"),
            }
            idx += 1
    params["masker"] = masker
    params["decoder"] = {"kernel": convt1d_w(sd["decoder.weight"])}
    return params


def _gn(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {"norm": {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}}


def _mha(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {
        "in_proj_kernel": linear_w(sd[f"{prefix}.in_proj_weight"]),
        "in_proj_bias": sd[f"{prefix}.in_proj_bias"],
        "out_proj_kernel": linear_w(sd[f"{prefix}.out_proj.weight"]),
        "out_proj_bias": sd[f"{prefix}.out_proj.bias"],
    }


def _lstm_dir(sd: Mapping[str, np.ndarray], prefix: str, suffix: str) -> dict:
    return {
        "w_ih": linear_w(sd[f"{prefix}.weight_ih_l0{suffix}"]),
        "w_hh": linear_w(sd[f"{prefix}.weight_hh_l0{suffix}"]),
        "b_ih": sd[f"{prefix}.bias_ih_l0{suffix}"],
        "b_hh": sd[f"{prefix}.bias_hh_l0{suffix}"],
    }


def dptnet_params_from_torch(sd: Mapping[str, np.ndarray], layer: int = 6) -> dict:
    """Map a reference float DPTNetQ state_dict (dptnetq.py:311-428) onto
    fqss_tpu.models.dptnet.DPTNet's param tree."""
    dpt: dict = {}
    for i in range(layer):
        for kind, mine in (("row_transformer", "row"), ("col_transformer", "col")):
            p = f"separator.DPT.{kind}.{i}.transformer"
            dpt[f"{mine}_{i}"] = {
                "self_attn": _mha(sd, f"{p}.self_attn"),
                "lstm": {"fw": _lstm_dir(sd, f"{p}.lstm", ""), "bw": _lstm_dir(sd, f"{p}.lstm", "_reverse")},
                "linear": {"kernel": linear_w(sd[f"{p}.linear.weight"]), "bias": sd[f"{p}.linear.bias"]},
                "norm1": _gn(sd, f"{p}.norm1"),
                "norm2": _gn(sd, f"{p}.norm2"),
            }
    dpt["out_prelu"] = {"nl": {"alpha": sd["separator.DPT.output.0.weight"]}}
    w_out = sd["separator.DPT.output.1.weight"]  # [O, I, 1, 1]
    dpt["out_conv"] = {"kernel": linear_w(w_out.reshape(w_out.shape[0], w_out.shape[1])),
                       "bias": sd["separator.DPT.output.1.bias"]}
    return {
        "encoder": {"conv": {"kernel": conv1d_w(sd["encoder.conv1d_U.weight"])}},
        "enc_LN": _gn(sd, "enc_LN"),
        "separator": {
            "BN": {"kernel": conv1d_w(sd["separator.BN.weight"])},
            "DPT": dpt,
            "output": {**_conv(sd, "separator.output.0")},
            "output_gate": {**_conv(sd, "separator.output_gate.0")},
        },
        "mask_conv1x1": {"kernel": conv1d_w(sd["mask_conv1x1.0.weight"])},
        "decoder": {"kernel": linear_w(sd["decoder.basis_signals.weight"])},
    }


def sepformer_params_from_torch(sd: Mapping[str, np.ndarray], n_repeats: int = 2, n_layers: int = 8) -> dict:
    """Map a reference float SepformerQ state_dict (sepformerq.py:342-470)
    onto fqss_tpu.models.sepformer.Sepformer's param tree."""

    def block(p: str) -> dict:
        out = {"norm": _gn(sd, f"{p}.norm")}
        for li in range(n_layers):
            q = f"{p}.layers.{li}"
            out[f"layer_{li}"] = {
                "norm1": _gn(sd, f"{q}.norm1"),
                "norm2": _gn(sd, f"{q}.norm2"),
                "mha": _mha(sd, f"{q}.mha"),
                "ffn_in": {"kernel": linear_w(sd[f"{q}.ffn.0.weight"]), "bias": sd[f"{q}.ffn.0.bias"]},
                "ffn_out": {"kernel": linear_w(sd[f"{q}.ffn.3.weight"]), "bias": sd[f"{q}.ffn.3.bias"]},
            }
        return out

    masker: dict = {
        "norm": _gn(sd, "masker.norm"),
        "conv1d": {"kernel": conv1d_w(sd["masker.conv1d.weight"])},
        "prelu": {"nl": {"alpha": sd["masker.prelu.weight"]}},
        "net_out": _conv(sd, "masker.net_out.0"),
        "net_gate": _conv(sd, "masker.net_gate.0"),
        "end_conv": {"kernel": conv1d_w(sd["masker.end_conv.0.weight"])},
    }
    w2d = sd["masker.conv2d.weight"]  # [O, I, 1, 1]
    masker["conv2d"] = {"kernel": linear_w(w2d.reshape(w2d.shape[0], w2d.shape[1])),
                        "bias": sd["masker.conv2d.bias"]}
    for r in range(n_repeats):
        masker[f"dp_{r}"] = {
            "intra_transformer_block": block(f"masker.layers.{r}.intra_transformer_block"),
            "inter_transformer_block": block(f"masker.layers.{r}.inter_transformer_block"),
            "intra_norm": _gn(sd, f"masker.layers.{r}.intra_norm"),
            "inter_norm": _gn(sd, f"masker.layers.{r}.inter_norm"),
        }
    return {
        "encoder": {"conv": {"kernel": conv1d_w(sd["encoder.0.weight"])}},
        "masker": masker,
        "decoder": {"kernel": convt1d_w(sd["decoder.weight"])},
    }


def convtasnet_music_params_from_torch(sd: Mapping[str, np.ndarray], n_repeats: int = 4, n_blocks: int = 10) -> dict:
    """Map a reference float ConvTasNetMusicQ state_dict
    (convtasnetq_music.py:178-288) onto ConvTasNetMusic's param tree."""
    sep: dict = {
        "layer_norm": {"norm": {"scale": sd["separator.network.0.norm.weight"],
                                "bias": sd["separator.network.0.norm.bias"]}},
        "bottleneck": {"kernel": conv1d_w(sd["separator.network.1.weight"])},
        "mask_conv": {"kernel": conv1d_w(sd["separator.network.3.weight"])},
    }
    for r in range(n_repeats):
        for x in range(n_blocks):
            p = f"separator.network.2.{r}.{x}"
            sep[f"tcn_{r}_{x}"] = {
                "conv1x1": {"kernel": conv1d_w(sd[f"{p}.net.0.weight"]),
                            "nl": {"alpha": sd[f"{p}.net.1.weight"]}},
                "norm": _gn(sd, f"{p}.net.2"),
                "dsconv": {
                    "depthwise": {"kernel": conv1d_w(sd[f"{p}.net.3.net.0.weight"]),
                                  "nl": {"alpha": sd[f"{p}.net.3.net.1.weight"]}},
                    "norm": _gn(sd, f"{p}.net.3.net.2"),
                    "pointwise": {"kernel": conv1d_w(sd[f"{p}.net.3.net.3.weight"])},
                },
            }
    return {
        "encoder": {"conv": {"kernel": conv1d_w(sd["encoder.0.weight"])}},
        "separator": sep,
        "decoder": {"kernel": linear_w(sd["decoder.weight"])},
    }


def _dconv(sd: Mapping[str, np.ndarray], prefix: str, depth: int = 2) -> dict:
    out = {}
    for d in range(depth):
        p = f"{prefix}.layers.{d}"
        out[f"layer_{d}_conv"] = {
            "kernel": conv1d_w(sd[f"{p}.0.weight"]), "bias": sd[f"{p}.0.bias"],
            "norm": {"scale": sd[f"{p}.1.weight"], "bias": sd[f"{p}.1.bias"]},
        }
        out[f"layer_{d}_mix"] = {
            "kernel": conv1d_w(sd[f"{p}.3.weight"]), "bias": sd[f"{p}.3.bias"],
            "norm": {"scale": sd[f"{p}.4.weight"], "bias": sd[f"{p}.4.bias"]},
        }
        out[f"layer_{d}_scale"] = {"scale": sd[f"{p}.6.scale"]}
    return out


def htdemucs_params_from_torch(
    sd: Mapping[str, np.ndarray], depth: int = 4, t_layers: int = 5, dconv_depth: int = 2
) -> dict:
    """Map a reference float HTDemucsQ state_dict (htdemucsq.py:532-930)
    onto fqss_tpu.models.htdemucs.HTDemucs' param tree (default topology:
    no branch merge, dconv in encoders only)."""

    def henc(p: str, freq: bool) -> dict:
        wt = conv2d_w(sd[f"{p}.conv.weight"]) if freq else conv1d_w(sd[f"{p}.conv.weight"])
        wr = conv2d_w(sd[f"{p}.rewrite.weight"]) if freq else conv1d_w(sd[f"{p}.rewrite.weight"])
        return {
            "conv": {"kernel": wt, "bias": sd[f"{p}.conv.bias"]},
            "rewrite": {"kernel": wr, "bias": sd[f"{p}.rewrite.bias"]},
            "dconv": _dconv(sd, f"{p}.dconv", dconv_depth),
        }

    def hdec(p: str, freq: bool) -> dict:
        wt = convt2d_w(sd[f"{p}.conv_tr.weight"]) if freq else convt1d_w(sd[f"{p}.conv_tr.weight"])
        wr = conv2d_w(sd[f"{p}.rewrite.weight"]) if freq else conv1d_w(sd[f"{p}.rewrite.weight"])
        return {
            "conv_tr": {"kernel": wt, "bias": sd[f"{p}.conv_tr.bias"]},
            "rewrite": {"kernel": wr, "bias": sd[f"{p}.rewrite.bias"]},
        }

    def ln(p: str) -> dict:
        return {"norm": {"scale": sd[f"{p}.weight"], "bias": sd[f"{p}.bias"]}}

    def tlayer(p: str, cross: bool) -> dict:
        out = {
            ("cross_attn" if cross else "self_attn"): _mha(sd, f"{p}.{'cross_attn' if cross else 'self_attn'}"),
            "norm1": ln(f"{p}.norm1"),
            "norm2": ln(f"{p}.norm2"),
            "linear1": {"kernel": linear_w(sd[f"{p}.linear1.weight"]), "bias": sd[f"{p}.linear1.bias"]},
            "linear2": {"kernel": linear_w(sd[f"{p}.linear2.weight"]), "bias": sd[f"{p}.linear2.bias"]},
            "norm_out": ln(f"{p}.norm_out"),
            "gamma_1": {"scale": sd[f"{p}.gamma_1.scale"]},
            "gamma_2": {"scale": sd[f"{p}.gamma_2.scale"]},
        }
        if cross:
            out["norm3"] = ln(f"{p}.norm3")
        return out

    params: dict = {"freq_emb": {"embedding": sd["freq_emb.embedding.weight"]}}
    # bottom_channels > 0: 1x1 samplers around the transformer (htdemucsq.py:880-892)
    for name in ("channel_upsampler", "channel_upsampler_t", "channel_downsampler", "channel_downsampler_t"):
        if f"{name}.weight" in sd:
            params[name] = {"kernel": conv1d_w(sd[f"{name}.weight"]), "bias": sd[f"{name}.bias"]}
    for i in range(depth):
        params[f"encoder_{i}"] = henc(f"encoder.{i}", freq=True)
        params[f"tencoder_{i}"] = henc(f"tencoder.{i}", freq=False)
        params[f"decoder_{i}"] = hdec(f"decoder.{i}", freq=True)
        params[f"tdecoder_{i}"] = hdec(f"tdecoder.{i}", freq=False)
    ct: dict = {"norm_in": ln("crosstransformer.norm_in"), "norm_in_t": ln("crosstransformer.norm_in_t")}
    for i in range(t_layers):
        cross = i % 2 == 1
        ct[f"layer_{i}"] = tlayer(f"crosstransformer.layers.{i}", cross)
        ct[f"layer_t_{i}"] = tlayer(f"crosstransformer.layers_t.{i}", cross)
    params["crosstransformer"] = ct
    return params


# ---------------------------------------------------------------------------
# QAT-state import: reference post-surgery state dicts (learned ranges incl.)
# ---------------------------------------------------------------------------


def _wq_ranges(sd: Mapping[str, np.ndarray], prefix: str, to_last_axis: bool = True) -> dict:
    """Weight-quantizer ranges: torch keepdim-on-first-axis -> ours on last."""
    mn = sd[f"{prefix}.min_range"]
    mx = sd[f"{prefix}.max_range"]
    if to_last_axis:
        mn = np.moveaxis(mn, 0, -1)
        mx = np.moveaxis(mx, 0, -1)
    return {"min_range": np.ascontiguousarray(mn), "max_range": np.ascontiguousarray(mx)}


def _aq_ranges(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    return {"min_range": sd[f"{prefix}.min_range"], "max_range": sd[f"{prefix}.max_range"]}


def _aq_only(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    """A module whose only quantizer state is its output act quantizer
    (AddQ/MulQ/ConstQ/NlQ)."""
    return {"activation_fake_quantize": _aq_ranges(sd, f"{prefix}.activation_fake_quantize")}


def _mha_qat(sd: Mapping[str, np.ndarray], p: str) -> tuple[dict, dict]:
    """MultiheadAttentionQ (qat_layers.py:865-990) -> QMultiheadAttention.
    ``p`` is the wrapped module path; the inner torch MHA is its ``mha``."""
    prm = {
        "in_proj_kernel": linear_w(sd[f"{p}.mha.in_proj_weight"]),
        "in_proj_bias": sd[f"{p}.mha.in_proj_bias"],
        "out_proj_kernel": linear_w(sd[f"{p}.mha.out_proj.weight"]),
        "out_proj_bias": sd[f"{p}.mha.out_proj.bias"],
    }
    qp = {"weight_fake_quantize_in": _wq_ranges(sd, f"{p}.weight_fake_quantize_in"),
          "weight_fake_quantize_out": _wq_ranges(sd, f"{p}.weight_fake_quantize_out")}
    for site in ("q", "k", "v", "div", "attn", "softmax", "head"):
        qp[f"activation_fake_quantize_{site}"] = _aq_ranges(sd, f"{p}.activation_fake_quantize_{site}")
    qp["activation_fake_quantize"] = _aq_ranges(sd, f"{p}.activation_fake_quantize")
    return prm, qp


def convtasnet_qat_from_torch(sd: Mapping[str, np.ndarray], n_repeats: int = 3, n_blocks: int = 8,
                              n_combiner: int = 2) -> tuple[dict, dict]:
    """Map a reference QAT ConvTasNetQ state_dict (post quantize_model
    surgery, convtasnetq.py:243-288) onto (params, qparams).

    Load into a model built with observer=False so the imported learned
    ranges are used as-is (val.py:197-198 semantics).
    """
    params: dict = {}
    qparams: dict = {}

    # encoder: Conv1dEncoderQ (already splitter-widened by the surgery)
    params["encoder"] = {"conv": {"kernel": conv1d_w(sd["encoder.conv1d.weight"])}}
    qparams["encoder"] = {"conv": {
        "weight_fake_quantize": _wq_ranges(sd, "encoder.weight_fake_quantize"),
        "activation_fake_quantize": _aq_ranges(sd, "encoder.activation_fake_quantize"),
    }}

    def conv_q(p: str, nl: bool = False) -> tuple[dict, dict]:
        prm = {"kernel": conv1d_w(sd[f"{p}.conv1d.weight"])}
        if f"{p}.conv1d.bias" in sd:
            prm["bias"] = sd[f"{p}.conv1d.bias"]
        if nl:
            prm["nl"] = {"alpha": sd[f"{p}.nl.weight"]}
        qp = {
            "weight_fake_quantize": _wq_ranges(sd, f"{p}.weight_fake_quantize"),
            "activation_fake_quantize": _aq_ranges(sd, f"{p}.activation_fake_quantize"),
        }
        return prm, qp

    def gn_q(p: str) -> tuple[dict, dict]:
        prm = {"norm": {"scale": sd[f"{p}.groupnorm.weight"], "bias": sd[f"{p}.groupnorm.bias"]}}
        qp = {"activation_fake_quantize": _aq_ranges(sd, f"{p}.activation_fake_quantize")}
        return prm, qp

    masker_p: dict = {}
    masker_q: dict = {}
    masker_p["bottleneck_norm"], masker_q["bottleneck_norm"] = gn_q("masker.bottleneck.0")
    masker_p["bottleneck_conv"], masker_q["bottleneck_conv"] = conv_q("masker.bottleneck.1")
    idx = 0
    for s in range(n_repeats):
        for layer in range(n_blocks):
            p = f"masker.TCN.{idx}"
            blk_p: dict = {}
            blk_q: dict = {}
            blk_p["conv_in"], blk_q["conv_in"] = conv_q(f"{p}.shared_block.0", nl=True)
            blk_p["norm_in"], blk_q["norm_in"] = gn_q(f"{p}.shared_block.2")
            blk_p["conv_dw"], blk_q["conv_dw"] = conv_q(f"{p}.shared_block.3", nl=True)
            blk_p["norm_dw"], blk_q["norm_dw"] = gn_q(f"{p}.shared_block.5")
            blk_p["res_conv"], blk_q["res_conv"] = conv_q(f"{p}.res_conv")
            blk_p["skip_conv"], blk_q["skip_conv"] = conv_q(f"{p}.skip_conv")
            blk_q["add"] = {"activation_fake_quantize": _aq_ranges(sd, f"{p}.add.activation_fake_quantize")}
            masker_p[f"tcn_{s}_{layer}"] = blk_p
            masker_q[f"tcn_{s}_{layer}"] = blk_q
            if idx < n_repeats * n_blocks - 1:
                masker_q[f"skip_add_{idx}"] = {
                    "activation_fake_quantize": _aq_ranges(sd, f"masker.adds.{idx}.activation_fake_quantize")
                }
            idx += 1
    masker_p["mask_prelu"] = {"nl": {"alpha": sd["masker.mask_net.0.nl.weight"]}}
    masker_q["mask_prelu"] = {"activation_fake_quantize": _aq_ranges(sd, "masker.mask_net.0.activation_fake_quantize")}
    masker_p["mask_conv"], masker_q["mask_conv"] = conv_q("masker.mask_net.1")
    params["masker"] = masker_p
    qparams["masker"] = masker_q

    qparams["mul"] = {"activation_fake_quantize": _aq_ranges(sd, "mul.activation_fake_quantize")}

    # decoder: ConvTr1dDecoderQ (+ residual error block for the combiner)
    dec_p: dict = {"kernel": convt1d_w(sd["decoder.convTr1d.weight"])}
    dec_q: dict = {
        # torch convT ranges are keepdim on axis 1 [1, Co, 1] -> ours (1, 1, Co)
        "weight_fake_quantize": {
            "min_range": np.moveaxis(sd["decoder.weight_fake_quantize.min_range"], 1, -1),
            "max_range": np.moveaxis(sd["decoder.weight_fake_quantize.max_range"], 1, -1),
        },
        "activation_fake_quantize": _aq_ranges(sd, "decoder.activation_fake_quantize"),
    }
    if n_combiner >= 2:
        reb = "decoder.residual_error_block"
        dec_p["residual_error_block"] = {
            "residual_encoder": {"kernel": conv1d_w(sd[f"{reb}.residual_encoder.weight"])},
        }
        if f"{reb}.residual_encoder.bias" in sd:
            dec_p["residual_error_block"]["residual_encoder"]["bias"] = sd[f"{reb}.residual_encoder.bias"]
        dec_q["residual_error_block"] = {
            "residual_encoder": {"weight_fake_quantize": _wq_ranges(sd, f"{reb}.weight_fake_quantize")},
            "activation_fake_quantize": _aq_ranges(sd, f"{reb}.activation_fake_quantize"),
        }
        dec_q["activation_fake_quantize_residual"] = _aq_ranges(sd, "decoder.activation_fake_quantize_residual")
    params["decoder"] = dec_p
    qparams["decoder"] = dec_q
    return params, qparams


def dptnet_qat_from_torch(sd: Mapping[str, np.ndarray], layer: int = 6, n_combiner: int = 2) -> tuple[dict, dict]:
    """Map a reference QAT DPTNetQ state_dict (post quantize_model surgery,
    dptnetq.py:430-478) onto (params, qparams). Load with observer=False."""

    def conv_q(p: str, bias: bool = True, nl: bool = False) -> tuple[dict, dict]:
        prm = {"kernel": conv1d_w(sd[f"{p}.conv1d.weight"])}
        if bias and f"{p}.conv1d.bias" in sd:
            prm["bias"] = sd[f"{p}.conv1d.bias"]
        qp = {"weight_fake_quantize": _wq_ranges(sd, f"{p}.weight_fake_quantize"),
              "activation_fake_quantize": _aq_ranges(sd, f"{p}.activation_fake_quantize")}
        return prm, qp

    def mha_q(p: str) -> tuple[dict, dict]:
        prm = {
            "in_proj_kernel": linear_w(sd[f"{p}.mha.in_proj_weight"]),
            "in_proj_bias": sd[f"{p}.mha.in_proj_bias"],
            "out_proj_kernel": linear_w(sd[f"{p}.mha.out_proj.weight"]),
            "out_proj_bias": sd[f"{p}.mha.out_proj.bias"],
        }
        qp = {"weight_fake_quantize_in": _wq_ranges(sd, f"{p}.weight_fake_quantize_in"),
              "weight_fake_quantize_out": _wq_ranges(sd, f"{p}.weight_fake_quantize_out")}
        for site in ("q", "k", "v", "div", "attn", "softmax", "head"):
            qp[f"activation_fake_quantize_{site}"] = _aq_ranges(sd, f"{p}.activation_fake_quantize_{site}")
        qp["activation_fake_quantize"] = _aq_ranges(sd, f"{p}.activation_fake_quantize")
        return prm, qp

    def lstm_q(p: str) -> tuple[dict, dict]:
        prm = {
            "fw": _lstm_dir(sd, f"{p}.lstm", ""),
            "bw": _lstm_dir(sd, f"{p}.lstm", "_reverse"),
        }
        qp = {
            "fw": {"wq_ih": _wq_ranges(sd, f"{p}.weight_quantizers_dict.weight_ih_l0"),
                   "wq_hh": _wq_ranges(sd, f"{p}.weight_quantizers_dict.weight_hh_l0")},
            "bw": {"wq_ih": _wq_ranges(sd, f"{p}.weight_quantizers_dict.weight_ih_l0_reverse"),
                   "wq_hh": _wq_ranges(sd, f"{p}.weight_quantizers_dict.weight_hh_l0_reverse")},
            "activation_fake_quantize": _aq_ranges(sd, f"{p}.activation_fake_quantize"),
        }
        return prm, qp

    def ln_q(p: str) -> tuple[dict, dict]:
        prm = {"norm": {"scale": sd[f"{p}.layernorm.weight"], "bias": sd[f"{p}.layernorm.bias"]}}
        qp = {"activation_fake_quantize": _aq_ranges(sd, f"{p}.activation_fake_quantize")}
        return prm, qp

    def tlayer_q(p: str) -> tuple[dict, dict]:
        prm: dict = {}
        qp: dict = {}
        prm["self_attn"], qp["self_attn"] = mha_q(f"{p}.self_attn")
        prm["lstm"], qp["lstm"] = lstm_q(f"{p}.lstm")
        prm["linear"] = {"kernel": linear_w(sd[f"{p}.linear.linear.weight"]),
                         "bias": sd[f"{p}.linear.linear.bias"]}
        qp["linear"] = {"weight_fake_quantize": _wq_ranges(sd, f"{p}.linear.weight_fake_quantize"),
                        "activation_fake_quantize": _aq_ranges(sd, f"{p}.linear.activation_fake_quantize")}
        prm["norm1"], qp["norm1"] = ln_q(f"{p}.norm1")
        prm["norm2"], qp["norm2"] = ln_q(f"{p}.norm2")
        qp["add_norm1"] = {"activation_fake_quantize": _aq_ranges(sd, f"{p}.add_norm1.activation_fake_quantize")}
        qp["add_norm2"] = {"activation_fake_quantize": _aq_ranges(sd, f"{p}.add_norm2.activation_fake_quantize")}
        return prm, qp

    params: dict = {}
    qparams: dict = {}

    params["encoder"] = {"conv": {"kernel": conv1d_w(sd["encoder.conv1d_U.conv1d.weight"])}}
    qparams["encoder"] = {"conv": {
        "weight_fake_quantize": _wq_ranges(sd, "encoder.conv1d_U.weight_fake_quantize"),
        "activation_fake_quantize": _aq_ranges(sd, "encoder.conv1d_U.activation_fake_quantize"),
    }}
    params["enc_LN"] = {"norm": {"scale": sd["enc_LN.groupnorm.weight"], "bias": sd["enc_LN.groupnorm.bias"]}}
    qparams["enc_LN"] = {"activation_fake_quantize": _aq_ranges(sd, "enc_LN.activation_fake_quantize")}

    sep_p: dict = {}
    sep_q: dict = {}
    sep_p["BN"], sep_q["BN"] = conv_q("separator.BN", bias=False)
    dpt_p: dict = {}
    dpt_q: dict = {}
    for i in range(layer):
        for kind, mine in (("row_transformer", "row"), ("col_transformer", "col")):
            dpt_p[f"{mine}_{i}"], dpt_q[f"{mine}_{i}"] = tlayer_q(f"separator.DPT.{kind}.{i}.transformer")
    dpt_p["out_prelu"] = {"nl": {"alpha": sd["separator.DPT.output.0.nl.weight"]}}
    dpt_q["out_prelu"] = {"activation_fake_quantize": _aq_ranges(sd, "separator.DPT.output.0.activation_fake_quantize")}
    w2 = sd["separator.DPT.output.1.conv2d.weight"]
    dpt_p["out_conv"] = {"kernel": linear_w(w2.reshape(w2.shape[0], w2.shape[1])),
                         "bias": sd["separator.DPT.output.1.conv2d.bias"]}
    dpt_q["out_conv"] = {
        "weight_fake_quantize": {
            "min_range": sd["separator.DPT.output.1.weight_fake_quantize.min_range"].reshape(1, -1),
            "max_range": sd["separator.DPT.output.1.weight_fake_quantize.max_range"].reshape(1, -1),
        },
        "activation_fake_quantize": _aq_ranges(sd, "separator.DPT.output.1.activation_fake_quantize"),
    }
    sep_p["DPT"] = dpt_p
    sep_q["DPT"] = dpt_q
    sep_p["output"], sep_q["output"] = conv_q("separator.output.0", nl=False)
    sep_p["output_gate"], sep_q["output_gate"] = conv_q("separator.output_gate.0", nl=False)
    sep_q["mul"] = {"activation_fake_quantize": _aq_ranges(sd, "separator.mul.activation_fake_quantize")}
    sep_q["add"] = {"activation_fake_quantize": _aq_ranges(sd, "separator.add.activation_fake_quantize")}
    params["separator"] = sep_p
    qparams["separator"] = sep_q

    params["mask_conv1x1"], qparams["mask_conv1x1"] = conv_q("mask_conv1x1.0", bias=False)
    qparams["mul"] = {"activation_fake_quantize": _aq_ranges(sd, "mul.activation_fake_quantize")}

    dec_p: dict = {"kernel": linear_w(sd["decoder.basis_signals.linear.weight"])}
    dec_q: dict = {
        "weight_fake_quantize": _wq_ranges(sd, "decoder.basis_signals.weight_fake_quantize"),
        "activation_fake_quantize": _aq_ranges(sd, "decoder.basis_signals.activation_fake_quantize"),
    }
    if n_combiner >= 2:
        reb = "decoder.basis_signals.residual_error_block"
        dec_p["residual_error_block"] = {
            "residual_encoder_kernel": linear_w(sd[f"{reb}.residual_encoder.weight"]),
        }
        if f"{reb}.residual_encoder.bias" in sd:
            dec_p["residual_error_block"]["residual_encoder_bias"] = sd[f"{reb}.residual_encoder.bias"]
        dec_q["residual_error_block"] = {
            "weight_fake_quantize": _wq_ranges(sd, f"{reb}.weight_fake_quantize"),
            "activation_fake_quantize": _aq_ranges(sd, f"{reb}.activation_fake_quantize"),
        }
        dec_q["activation_fake_quantize_residual"] = _aq_ranges(sd, "decoder.basis_signals.activation_fake_quantize_residual")
    params["decoder"] = dec_p
    qparams["decoder"] = dec_q
    return params, qparams


def sepformer_qat_from_torch(sd: Mapping[str, np.ndarray], n_repeats: int = 2, n_layers: int = 8,
                             n_combiner: int = 2) -> tuple[dict, dict]:
    """Map a reference QAT SepformerQ state_dict (post quantize_model surgery,
    sepformerq.py:472-527) onto (params, qparams) for
    fqss_tpu.models.sepformer.Sepformer. Load with observer=False.

    The Sepformer combiner trains its residual decoder (train_res_dec=True,
    sepformerq.py:501), so the residual block carries both a residual encoder
    AND a trainable residual decoder with its own weight quantizer.
    """

    def conv_q(p: str, bias: bool = True) -> tuple[dict, dict]:
        prm = {"kernel": conv1d_w(sd[f"{p}.conv1d.weight"])}
        if bias and f"{p}.conv1d.bias" in sd:
            prm["bias"] = sd[f"{p}.conv1d.bias"]
        qp = {"weight_fake_quantize": _wq_ranges(sd, f"{p}.weight_fake_quantize"),
              "activation_fake_quantize": _aq_ranges(sd, f"{p}.activation_fake_quantize")}
        return prm, qp

    def ln_q(p: str) -> tuple[dict, dict]:
        prm = {"norm": {"scale": sd[f"{p}.layernorm.weight"], "bias": sd[f"{p}.layernorm.bias"]}}
        return prm, _aq_only(sd, p)

    def gn_q(p: str) -> tuple[dict, dict]:
        prm = {"norm": {"scale": sd[f"{p}.groupnorm.weight"], "bias": sd[f"{p}.groupnorm.bias"]}}
        return prm, _aq_only(sd, p)

    def dense_q(p: str) -> tuple[dict, dict]:
        prm = {"kernel": linear_w(sd[f"{p}.linear.weight"]), "bias": sd[f"{p}.linear.bias"]}
        qp = {"weight_fake_quantize": _wq_ranges(sd, f"{p}.weight_fake_quantize"),
              "activation_fake_quantize": _aq_ranges(sd, f"{p}.activation_fake_quantize")}
        return prm, qp

    def tblock(p: str) -> tuple[dict, dict]:
        bp: dict = {}
        bq: dict = {"pos_const": _aq_only(sd, f"{p}.pos.const"), "pos_add": _aq_only(sd, f"{p}.pos_add")}
        bp["norm"], bq["norm"] = ln_q(f"{p}.norm")
        for li in range(n_layers):
            q0 = f"{p}.layers.{li}"
            lp: dict = {}
            lq: dict = {"ffn_relu": _aq_only(sd, f"{q0}.ffn.1")}
            lp["norm1"], lq["norm1"] = ln_q(f"{q0}.norm1")
            lp["norm2"], lq["norm2"] = ln_q(f"{q0}.norm2")
            lp["mha"], lq["mha"] = _mha_qat(sd, f"{q0}.mha")
            lp["ffn_in"], lq["ffn_in"] = dense_q(f"{q0}.ffn.0")
            lp["ffn_out"], lq["ffn_out"] = dense_q(f"{q0}.ffn.3")
            bp[f"layer_{li}"], bq[f"layer_{li}"] = lp, lq
        return bp, bq

    params: dict = {"encoder": {"conv": {"kernel": conv1d_w(sd["encoder.0.conv1d.weight"])}}}
    qparams: dict = {"encoder": {"conv": {
        "weight_fake_quantize": _wq_ranges(sd, "encoder.0.weight_fake_quantize"),
        "activation_fake_quantize": _aq_ranges(sd, "encoder.0.activation_fake_quantize"),
    }}}

    mp: dict = {}
    mq: dict = {"mul": _aq_only(sd, "masker.mul"), "prelu": _aq_only(sd, "masker.prelu")}
    mp["norm"], mq["norm"] = gn_q("masker.norm")
    mp["conv1d"], mq["conv1d"] = conv_q("masker.conv1d", bias=False)
    for r in range(n_repeats):
        p = f"masker.layers.{r}"
        dp_p: dict = {}
        dp_q: dict = {"intra_add": _aq_only(sd, f"{p}.intra_add"), "inter_add": _aq_only(sd, f"{p}.inter_add")}
        dp_p["intra_transformer_block"], dp_q["intra_transformer_block"] = tblock(f"{p}.intra_transformer_block")
        dp_p["inter_transformer_block"], dp_q["inter_transformer_block"] = tblock(f"{p}.inter_transformer_block")
        dp_p["intra_norm"], dp_q["intra_norm"] = gn_q(f"{p}.intra_norm")
        dp_p["inter_norm"], dp_q["inter_norm"] = gn_q(f"{p}.inter_norm")
        mp[f"dp_{r}"], mq[f"dp_{r}"] = dp_p, dp_q
    mp["prelu"] = {"nl": {"alpha": sd["masker.prelu.nl.weight"]}}
    # 1x1 Conv2dQ over channels-last == dense
    w2d = sd["masker.conv2d.conv2d.weight"]  # [O, I, 1, 1]
    mp["conv2d"] = {"kernel": linear_w(w2d.reshape(w2d.shape[0], w2d.shape[1])),
                    "bias": sd["masker.conv2d.conv2d.bias"]}
    mq["conv2d"] = {
        "weight_fake_quantize": {
            "min_range": sd["masker.conv2d.weight_fake_quantize.min_range"].reshape(1, -1),
            "max_range": sd["masker.conv2d.weight_fake_quantize.max_range"].reshape(1, -1),
        },
        "activation_fake_quantize": _aq_ranges(sd, "masker.conv2d.activation_fake_quantize"),
    }
    mp["net_out"], mq["net_out"] = conv_q("masker.net_out.0")
    mp["net_gate"], mq["net_gate"] = conv_q("masker.net_gate.0")
    mp["end_conv"], mq["end_conv"] = conv_q("masker.end_conv.0", bias=False)
    params["masker"] = mp
    qparams["masker"] = mq

    qparams["mul"] = _aq_only(sd, "mul")

    dec_p: dict = {"kernel": convt1d_w(sd["decoder.convTr1d.weight"])}
    dec_q: dict = {
        "weight_fake_quantize": {
            "min_range": np.moveaxis(sd["decoder.weight_fake_quantize.min_range"], 1, -1),
            "max_range": np.moveaxis(sd["decoder.weight_fake_quantize.max_range"], 1, -1),
        },
        "activation_fake_quantize": _aq_ranges(sd, "decoder.activation_fake_quantize"),
    }
    if n_combiner >= 2:
        reb = "decoder.residual_error_block"
        dec_p["residual_error_block"] = {
            "residual_encoder": {"kernel": conv1d_w(sd[f"{reb}.residual_encoder.weight"])},
            # trainable residual decoder (train_res_dec=True)
            "residual_decoder_kernel": convt1d_w(sd[f"{reb}.residual_decoder.weight"]),
        }
        if f"{reb}.residual_encoder.bias" in sd:
            dec_p["residual_error_block"]["residual_encoder"]["bias"] = sd[f"{reb}.residual_encoder.bias"]
        dec_q["residual_error_block"] = {
            "residual_encoder": {"weight_fake_quantize": _wq_ranges(sd, f"{reb}.weight_fake_quantize")},
            "weight_fake_quantize_dec": {
                "min_range": np.moveaxis(sd[f"{reb}.weight_fake_quantize_dec.min_range"], 1, -1),
                "max_range": np.moveaxis(sd[f"{reb}.weight_fake_quantize_dec.max_range"], 1, -1),
            },
            "activation_fake_quantize": _aq_ranges(sd, f"{reb}.activation_fake_quantize"),
        }
        dec_q["activation_fake_quantize_residual"] = _aq_ranges(sd, "decoder.activation_fake_quantize_residual")
    params["decoder"] = dec_p
    qparams["decoder"] = dec_q
    return params, qparams


def convtasnet_music_qat_from_torch(sd: Mapping[str, np.ndarray], n_repeats: int = 4, n_blocks: int = 10,
                                    n_combiner: int = 2) -> tuple[dict, dict]:
    """Map a reference QAT ConvTasNetMusicQ state_dict (post quantize_model
    surgery, convtasnetq_music.py:290-333) onto (params, qparams) for
    fqss_tpu.models.convtasnet_music.ConvTasNetMusic. Load with
    observer=False. The music combiner shares the decoder weight
    (train_res_dec=False, convtasnetq_music.py:320)."""

    def conv_q(p: str, nl: bool = False) -> tuple[dict, dict]:
        prm = {"kernel": conv1d_w(sd[f"{p}.conv1d.weight"])}
        if f"{p}.conv1d.bias" in sd:
            prm["bias"] = sd[f"{p}.conv1d.bias"]
        if nl:
            prm["nl"] = {"alpha": sd[f"{p}.nl.weight"]}
        qp = {"weight_fake_quantize": _wq_ranges(sd, f"{p}.weight_fake_quantize"),
              "activation_fake_quantize": _aq_ranges(sd, f"{p}.activation_fake_quantize")}
        return prm, qp

    def gn_q(p: str) -> tuple[dict, dict]:
        prm = {"norm": {"scale": sd[f"{p}.groupnorm.weight"], "bias": sd[f"{p}.groupnorm.bias"]}}
        return prm, _aq_only(sd, p)

    params: dict = {"encoder": {"conv": {"kernel": conv1d_w(sd["encoder.0.conv1d.weight"])}}}
    qparams: dict = {"encoder": {"conv": {
        "weight_fake_quantize": _wq_ranges(sd, "encoder.0.weight_fake_quantize"),
        "activation_fake_quantize": _aq_ranges(sd, "encoder.0.activation_fake_quantize"),
    }}}

    sep_p: dict = {"layer_norm": {"norm": {"scale": sd["separator.network.0.norm.layernorm.weight"],
                                           "bias": sd["separator.network.0.norm.layernorm.bias"]}}}
    sep_q: dict = {"layer_norm": _aq_only(sd, "separator.network.0.norm")}
    sep_p["bottleneck"], sep_q["bottleneck"] = conv_q("separator.network.1")
    for r in range(n_repeats):
        for x in range(n_blocks):
            p = f"separator.network.2.{r}.{x}"
            blk_p: dict = {}
            blk_q: dict = {"add": _aq_only(sd, f"{p}.add")}
            blk_p["conv1x1"], blk_q["conv1x1"] = conv_q(f"{p}.net.0", nl=True)
            blk_p["norm"], blk_q["norm"] = gn_q(f"{p}.net.2")
            ds_p: dict = {}
            ds_q: dict = {}
            ds_p["depthwise"], ds_q["depthwise"] = conv_q(f"{p}.net.3.net.0", nl=True)
            ds_p["norm"], ds_q["norm"] = gn_q(f"{p}.net.3.net.2")
            ds_p["pointwise"], ds_q["pointwise"] = conv_q(f"{p}.net.3.net.3")
            blk_p["dsconv"], blk_q["dsconv"] = ds_p, ds_q
            sep_p[f"tcn_{r}_{x}"], sep_q[f"tcn_{r}_{x}"] = blk_p, blk_q
    sep_p["mask_conv"], sep_q["mask_conv"] = conv_q("separator.network.3")
    params["separator"] = sep_p
    qparams["separator"] = sep_q

    qparams["mul"] = _aq_only(sd, "mul")

    dec_p: dict = {"kernel": linear_w(sd["decoder.linear.weight"])}
    dec_q: dict = {
        "weight_fake_quantize": _wq_ranges(sd, "decoder.weight_fake_quantize"),
        "activation_fake_quantize": _aq_ranges(sd, "decoder.activation_fake_quantize"),
    }
    if n_combiner >= 2:
        reb = "decoder.residual_error_block"
        dec_p["residual_error_block"] = {
            "residual_encoder_kernel": linear_w(sd[f"{reb}.residual_encoder.weight"]),
        }
        if f"{reb}.residual_encoder.bias" in sd:
            dec_p["residual_error_block"]["residual_encoder_bias"] = sd[f"{reb}.residual_encoder.bias"]
        dec_q["residual_error_block"] = {
            "weight_fake_quantize": _wq_ranges(sd, f"{reb}.weight_fake_quantize"),
            "activation_fake_quantize": _aq_ranges(sd, f"{reb}.activation_fake_quantize"),
        }
        dec_q["activation_fake_quantize_residual"] = _aq_ranges(sd, "decoder.activation_fake_quantize_residual")
    params["decoder"] = dec_p
    qparams["decoder"] = dec_q
    return params, qparams


def htdemucs_qat_from_torch(
    sd: Mapping[str, np.ndarray], depth: int = 4, t_layers: int = 5,
    dconv_depth: int = 2, n_combiner: int = 2,
) -> tuple[dict, dict]:
    """Map a reference QAT HTDemucsQ state_dict (post quantize_model surgery,
    htdemucsq.py:1157-1242) onto (params, qparams) for
    fqss_tpu.models.htdemucs.HTDemucs (default topology: bottom_channels=0,
    norm_starts >= depth so encoder/decoder norms are identity). Load with
    observer=False. The final frequency decoder trains its residual decoder
    (train_res_dec for 'decoder.3', htdemucsq.py:1194)."""

    def conv_q(p: str, freq: bool) -> tuple[dict, dict]:
        """Conv{1,2}d[Nl]Q / Conv{1,2}dEncoderQ: inner conv{1,2}d."""
        inner = "conv2d" if freq else "conv1d"
        w = conv2d_w(sd[f"{p}.{inner}.weight"]) if freq else conv1d_w(sd[f"{p}.{inner}.weight"])
        prm = {"kernel": w}
        if f"{p}.{inner}.bias" in sd:
            prm["bias"] = sd[f"{p}.{inner}.bias"]
        qp = {"weight_fake_quantize": _wq_ranges(sd, f"{p}.weight_fake_quantize"),
              "activation_fake_quantize": _aq_ranges(sd, f"{p}.activation_fake_quantize")}
        return prm, qp

    def dconv_gn_conv(p: str) -> tuple[dict, dict]:
        """Conv1dGnNlQ (fused conv+GroupNorm+NL, qat_layers.py:222-258)."""
        prm = {"kernel": conv1d_w(sd[f"{p}.conv1d.weight"]), "bias": sd[f"{p}.conv1d.bias"],
               "norm": {"scale": sd[f"{p}.gn.weight"], "bias": sd[f"{p}.gn.bias"]}}
        qp = {"weight_fake_quantize": _wq_ranges(sd, f"{p}.weight_fake_quantize"),
              "activation_fake_quantize": _aq_ranges(sd, f"{p}.activation_fake_quantize")}
        return prm, qp

    def dconv(p: str) -> tuple[dict, dict]:
        dp: dict = {}
        dq: dict = {}
        for d in range(dconv_depth):
            dp[f"layer_{d}_conv"], dq[f"layer_{d}_conv"] = dconv_gn_conv(f"{p}.layers.{d}.0")
            dp[f"layer_{d}_mix"], dq[f"layer_{d}_mix"] = dconv_gn_conv(f"{p}.layers.{d}.3")
            dp[f"layer_{d}_scale"] = {"scale": sd[f"{p}.layers.{d}.6.scale"]}
            dq[f"layer_{d}_scale"] = {"mul": _aq_only(sd, f"{p}.layers.{d}.6.mul")}
            dq[f"add_{d}"] = _aq_only(sd, f"{p}.adds.{d}")
        return dp, dq

    def henc(p: str, freq: bool) -> tuple[dict, dict]:
        ep: dict = {}
        eq: dict = {}
        ep["conv"], eq["conv"] = conv_q(f"{p}.conv", freq)
        ep["rewrite"], eq["rewrite"] = conv_q(f"{p}.rewrite", freq)
        ep["dconv"], eq["dconv"] = dconv(f"{p}.dconv")
        return ep, eq

    def convtr_q(p: str, freq: bool) -> tuple[dict, dict]:
        """ConvTranspose{1,2}d[Nl]Q (non-last decoders): inner convTr{1,2}d."""
        inner = "convTr2d" if freq else "convTr1d"
        w = convt2d_w(sd[f"{p}.{inner}.weight"]) if freq else convt1d_w(sd[f"{p}.{inner}.weight"])
        prm = {"kernel": w, "bias": sd[f"{p}.{inner}.bias"]}
        qp = {"weight_fake_quantize": {
                  "min_range": np.moveaxis(sd[f"{p}.weight_fake_quantize.min_range"], 1, -1),
                  "max_range": np.moveaxis(sd[f"{p}.weight_fake_quantize.max_range"], 1, -1)},
              "activation_fake_quantize": _aq_ranges(sd, f"{p}.activation_fake_quantize")}
        return prm, qp

    def dec_last(p: str, freq: bool, train_res_dec: bool) -> tuple[dict, dict]:
        """ConvTr{1,2}dDecoderQ (combiner I/O decoder, replace_decoderq)."""
        inner = "convTr2d" if freq else "convTr1d"
        w = convt2d_w(sd[f"{p}.{inner}.weight"]) if freq else convt1d_w(sd[f"{p}.{inner}.weight"])
        prm: dict = {"kernel": w, "bias": sd[f"{p}.{inner}.bias"]}
        qp: dict = {
            "weight_fake_quantize": {
                "min_range": np.moveaxis(sd[f"{p}.weight_fake_quantize.min_range"], 1, -1),
                "max_range": np.moveaxis(sd[f"{p}.weight_fake_quantize.max_range"], 1, -1)},
            "activation_fake_quantize": _aq_ranges(sd, f"{p}.activation_fake_quantize"),
        }
        if n_combiner >= 2:
            reb = f"{p}.residual_error_block"
            enc_w = conv2d_w(sd[f"{reb}.residual_encoder.weight"]) if freq else conv1d_w(sd[f"{reb}.residual_encoder.weight"])
            prm["residual_error_block"] = {"residual_encoder": {"kernel": enc_w}}
            if f"{reb}.residual_encoder.bias" in sd:
                prm["residual_error_block"]["residual_encoder"]["bias"] = sd[f"{reb}.residual_encoder.bias"]
            qp["residual_error_block"] = {
                "residual_encoder": {"weight_fake_quantize": _wq_ranges(sd, f"{reb}.weight_fake_quantize")},
                "activation_fake_quantize": _aq_ranges(sd, f"{reb}.activation_fake_quantize"),
            }
            if train_res_dec:
                dec_w = (convt2d_w(sd[f"{reb}.residual_decoder.weight"]) if freq
                         else convt1d_w(sd[f"{reb}.residual_decoder.weight"]))
                prm["residual_error_block"]["residual_decoder_kernel"] = dec_w
                if f"{reb}.residual_decoder.bias" in sd:
                    prm["residual_error_block"]["residual_decoder_bias"] = sd[f"{reb}.residual_decoder.bias"]
                qp["residual_error_block"]["weight_fake_quantize_dec"] = {
                    "min_range": np.moveaxis(sd[f"{reb}.weight_fake_quantize_dec.min_range"], 1, -1),
                    "max_range": np.moveaxis(sd[f"{reb}.weight_fake_quantize_dec.max_range"], 1, -1)}
            qp["activation_fake_quantize_residual"] = _aq_ranges(sd, f"{p}.activation_fake_quantize_residual")
        return prm, qp

    def hdec(p: str, freq: bool, last: bool, train_res_dec: bool = False) -> tuple[dict, dict]:
        dp: dict = {}
        dq: dict = {"add": _aq_only(sd, f"{p}.add")}
        dp["rewrite"], dq["rewrite"] = conv_q(f"{p}.rewrite", freq)
        if last:
            dp["conv_tr"], dq["conv_tr"] = dec_last(f"{p}.conv_tr", freq, train_res_dec)
        else:
            dp["conv_tr"], dq["conv_tr"] = convtr_q(f"{p}.conv_tr", freq)
        return dp, dq

    def ln_q(p: str) -> tuple[dict, dict]:
        prm = {"norm": {"scale": sd[f"{p}.layernorm.weight"], "bias": sd[f"{p}.layernorm.bias"]}}
        return prm, _aq_only(sd, p)

    def dense_q(p: str) -> tuple[dict, dict]:
        prm = {"kernel": linear_w(sd[f"{p}.linear.weight"]), "bias": sd[f"{p}.linear.bias"]}
        qp = {"weight_fake_quantize": _wq_ranges(sd, f"{p}.weight_fake_quantize"),
              "activation_fake_quantize": _aq_ranges(sd, f"{p}.activation_fake_quantize")}
        return prm, qp

    def tlayer(p: str, cross: bool) -> tuple[dict, dict]:
        lp: dict = {}
        lq: dict = {"add_norm1": _aq_only(sd, f"{p}.add_norm1"),
                    "add_norm2": _aq_only(sd, f"{p}.add_norm2"),
                    "norm_out": {"const": _aq_only(sd, f"{p}.norm_out.const")},
                    "gamma_1": {"mul": _aq_only(sd, f"{p}.gamma_1.mul")},
                    "gamma_2": {"mul": _aq_only(sd, f"{p}.gamma_2.mul")}}
        attn = "cross_attn" if cross else "self_attn"
        lp[attn], lq[attn] = _mha_qat(sd, f"{p}.{attn}")
        lp["norm1"], lq["norm1"] = ln_q(f"{p}.norm1")
        lp["norm2"], lq["norm2"] = ln_q(f"{p}.norm2")
        if cross:
            lp["norm3"], lq["norm3"] = ln_q(f"{p}.norm3")
        lp["linear1"], lq["linear1"] = dense_q(f"{p}.linear1")
        lp["linear2"], lq["linear2"] = dense_q(f"{p}.linear2")
        lp["norm_out"] = {"norm": {"scale": sd[f"{p}.norm_out.weight"], "bias": sd[f"{p}.norm_out.bias"]}}
        lp["gamma_1"] = {"scale": sd[f"{p}.gamma_1.scale"]}
        lp["gamma_2"] = {"scale": sd[f"{p}.gamma_2.scale"]}
        return lp, lq

    params: dict = {}
    qparams: dict = {}

    # ScaledEmbedding -> EmbeddingQ + MulQ (htdemucsq.py:1204-1205). The
    # embedding weight quantizer is per-row (ch axis 0) on both sides.
    params["freq_emb"] = {"embedding": sd["freq_emb.embedding.embedding.weight"]}
    qparams["freq_emb"] = {
        "weight_fake_quantize": _wq_ranges(sd, "freq_emb.embedding.weight_fake_quantize", to_last_axis=False),
        "activation_fake_quantize": _aq_ranges(sd, "freq_emb.embedding.activation_fake_quantize"),
        "mul": _aq_only(sd, "freq_emb.mul"),
    }
    qparams["mul_freq"] = _aq_only(sd, "mul_freq")
    qparams["add_freq"] = _aq_only(sd, "add_freq")

    # bottom_channels samplers -> Conv1dQ (htdemucsq.py:1198-1201)
    for name in ("channel_upsampler", "channel_upsampler_t", "channel_downsampler", "channel_downsampler_t"):
        if f"{name}.conv1d.weight" in sd:
            params[name], qparams[name] = conv_q(name, freq=False)

    for i in range(depth):
        last = i == depth - 1
        params[f"encoder_{i}"], qparams[f"encoder_{i}"] = henc(f"encoder.{i}", freq=True)
        params[f"tencoder_{i}"], qparams[f"tencoder_{i}"] = henc(f"tencoder.{i}", freq=False)
        params[f"decoder_{i}"], qparams[f"decoder_{i}"] = hdec(
            f"decoder.{i}", freq=True, last=last, train_res_dec=last)
        params[f"tdecoder_{i}"], qparams[f"tdecoder_{i}"] = hdec(
            f"tdecoder.{i}", freq=False, last=last, train_res_dec=False)

    ct_p: dict = {}
    ct_q: dict = {"add_x": _aq_only(sd, "crosstransformer.add_x"),
                  "add_xt": _aq_only(sd, "crosstransformer.add_xt"),
                  "const_pos_emb": _aq_only(sd, "crosstransformer.const_pos_emb"),
                  "const_pos_emb_2d": _aq_only(sd, "crosstransformer.const_pos_emb_2d")}
    ct_p["norm_in"], ct_q["norm_in"] = ln_q("crosstransformer.norm_in")
    ct_p["norm_in_t"], ct_q["norm_in_t"] = ln_q("crosstransformer.norm_in_t")
    for i in range(t_layers):
        cross = i % 2 == 1
        ct_p[f"layer_{i}"], ct_q[f"layer_{i}"] = tlayer(f"crosstransformer.layers.{i}", cross)
        ct_p[f"layer_t_{i}"], ct_q[f"layer_t_{i}"] = tlayer(f"crosstransformer.layers_t.{i}", cross)
    params["crosstransformer"] = ct_p
    qparams["crosstransformer"] = ct_q
    return params, qparams
