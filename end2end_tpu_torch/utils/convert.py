"""Carry weights from the JAX models to the torch port.

`conformer_state_dict_from_flax(params)` takes the flax parameter tree as
nested dicts of numpy arrays (for example `jax.device_get(params)`) and
returns a `state_dict` for `models.conformer.ConformerEncoder`;
`transducer_state_dict_from_jax` and `ocr_state_dict_from_flax` do the
same for the transducer and the OCR recognizer.  They
need neither jax nor flax.  Conformer layouts:
  * Dense kernels are (in, out): transposed to torch's (out, in);
  * 2-D conv kernels are HWIO: permuted to OIHW;
  * the depthwise kernel (15, 1, d) becomes (d, 1, 15);
  * attention q/k/v kernels (d, H, d/H) and out (H, d/H, d) flatten the
    head axes into the (d, d) of one Linear each.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))


class _Writer:
    """Writes flax leaves into a torch state_dict under the port's names."""

    def __init__(self):
        self.sd: dict[str, torch.Tensor] = {}

    def dense(self, name, d, flat_in=None):
        k = np.asarray(d["kernel"])
        k = k.reshape(flat_in or k.shape[0], -1)
        self.sd[f"{name}.weight"] = _t(k.T)
        self.sd[f"{name}.bias"] = _t(np.asarray(d["bias"]).reshape(-1))

    def layer_norm(self, name, d):
        self.sd[f"{name}.weight"] = _t(d["scale"])
        self.sd[f"{name}.bias"] = _t(d["bias"])

    def conv2d(self, name, d):
        self.sd[f"{name}.weight"] = _t(np.transpose(d["kernel"], (3, 2, 0, 1)))
        self.sd[f"{name}.bias"] = _t(d["bias"])

    def blocks(self, p):
        """Every `ConformerBlock_i` of p as `blocks.i`."""
        i = 0
        while f"ConformerBlock_{i}" in p:
            self.block(f"blocks.{i}", p[f"ConformerBlock_{i}"])
            i += 1

    def block(self, pre, blk):
        for j, ff in enumerate(("ff1", "ff2")):
            src = blk[f"FeedForward_{j}"]
            self.layer_norm(f"{pre}.{ff}.ln", src["LayerNorm_0"])
            self.dense(f"{pre}.{ff}.fc1", src["Dense_0"])
            self.dense(f"{pre}.{ff}.fc2", src["Dense_1"])
        mhsa = blk["MHSA_0"]
        self.layer_norm(f"{pre}.mhsa.ln", mhsa["LayerNorm_0"])
        att = mhsa["MultiHeadDotProductAttention_0"]
        for name in ("query", "key", "value"):
            self.dense(f"{pre}.mhsa.{name}", att[name])  # (d, H, dh) -> (d, d)
        h, dh, _ = np.shape(att["out"]["kernel"])
        self.dense(f"{pre}.mhsa.out", att["out"], flat_in=h * dh)
        cm = blk["ConvModule_0"]
        self.layer_norm(f"{pre}.conv.ln0", cm["LayerNorm_0"])
        self.dense(f"{pre}.conv.pw1", cm["Dense_0"])
        self.sd[f"{pre}.conv.dw.weight"] = _t(
            np.transpose(cm["Conv_0"]["kernel"], (2, 1, 0)))
        self.sd[f"{pre}.conv.dw.bias"] = _t(cm["Conv_0"]["bias"])
        self.layer_norm(f"{pre}.conv.ln1", cm["LayerNorm_1"])
        self.dense(f"{pre}.conv.pw2", cm["Dense_1"])
        self.layer_norm(f"{pre}.ln", blk["LayerNorm_0"])


def conformer_state_dict_from_flax(params) -> dict[str, torch.Tensor]:
    """Either front end: flax numbers its Dense modules in call order, so
    with a `ConvSubsampling_0` the output projection is `Dense_0`, and
    without one (subsample=False) the front end is `Dense_0` and the
    output projection `Dense_1`."""
    p = params.get("params", params)
    w = _Writer()
    if "ConvSubsampling_0" in p:
        sub = p["ConvSubsampling_0"]
        w.conv2d("subsample.conv0", sub["Conv_0"])
        w.conv2d("subsample.conv1", sub["Conv_1"])
        w.dense("subsample.dense", sub["Dense_0"])
        out = "Dense_0"
    else:
        w.dense("input_proj", p["Dense_0"])
        out = "Dense_1"
    w.blocks(p)
    w.dense("out", p[out])
    return w.sd


def ocr_state_dict_from_flax(params) -> dict[str, torch.Tensor]:
    """The JAX `OCRRecognizer`'s flax tree (`CRNNFeatures_0/Conv_0..2`,
    `ConformerBlock_i`, `Dense_0`) -> a `state_dict` for the port's
    `models.ocr.OCRRecognizer`: HWIO conv kernels to OIHW, the blocks as
    the Conformer's."""
    p = params.get("params", params)
    w = _Writer()
    for i in range(3):
        w.conv2d(f"features.conv{i}", p["CRNNFeatures_0"][f"Conv_{i}"])
    w.blocks(p)
    w.dense("out", p["Dense_0"])
    return w.sd


def transducer_state_dict_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX `ConformerTransducer`'s {"enc", "pred", "joint"} params
    (nested dicts of numpy arrays) -> a `state_dict` for the port's
    `models.transducer.ConformerTransducer`.  Layouts:
      * enc: the flax Conformer, through `conformer_state_dict_from_flax`;
      * pred: the GRU cell's arrays as they are: emb (V, E); wz, wr, wh
        (E+H, H), each applied to concat([x, h]) as ``xh @ w``; bz, br,
        bh (H,); wo (H, V), bo (V,);
      * joint: w_enc (E, J), w_pred (H, J), w_out (J, V) stay (in, out)
        matrices (the port multiplies ``x @ w`` as JAX does); b (J,),
        b_out (V,).
    """
    sd = {f"encoder.{k}": v
          for k, v in conformer_state_dict_from_flax(params["enc"]).items()}
    for part in ("pred", "joint"):
        for k, v in params[part].items():
            sd[f"{part}.{k}"] = _t(v)
    return sd
