"""Carry weights from the JAX models to the torch port.

`conformer_state_dict_from_flax(params)` takes the flax parameter tree as
nested dicts of numpy arrays (for example `jax.device_get(params)`) and
returns a `state_dict` for `models.conformer.ConformerEncoder`;
`transducer_state_dict_from_jax` does the same for the transducer.  They
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


def conformer_state_dict_from_flax(params) -> dict[str, torch.Tensor]:
    p = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}

    def dense(name, d, flat_in=None):
        k = np.asarray(d["kernel"])
        k = k.reshape(flat_in or k.shape[0], -1)
        sd[f"{name}.weight"] = _t(k.T)
        sd[f"{name}.bias"] = _t(np.asarray(d["bias"]).reshape(-1))

    def layer_norm(name, d):
        sd[f"{name}.weight"] = _t(d["scale"])
        sd[f"{name}.bias"] = _t(d["bias"])

    def conv2d(name, d):
        sd[f"{name}.weight"] = _t(np.transpose(d["kernel"], (3, 2, 0, 1)))
        sd[f"{name}.bias"] = _t(d["bias"])

    sub = p["ConvSubsampling_0"]
    conv2d("subsample.conv0", sub["Conv_0"])
    conv2d("subsample.conv1", sub["Conv_1"])
    dense("subsample.dense", sub["Dense_0"])
    i = 0
    while f"ConformerBlock_{i}" in p:
        blk, pre = p[f"ConformerBlock_{i}"], f"blocks.{i}"
        for j, ff in enumerate(("ff1", "ff2")):
            src = blk[f"FeedForward_{j}"]
            layer_norm(f"{pre}.{ff}.ln", src["LayerNorm_0"])
            dense(f"{pre}.{ff}.fc1", src["Dense_0"])
            dense(f"{pre}.{ff}.fc2", src["Dense_1"])
        mhsa = blk["MHSA_0"]
        layer_norm(f"{pre}.mhsa.ln", mhsa["LayerNorm_0"])
        att = mhsa["MultiHeadDotProductAttention_0"]
        for name in ("query", "key", "value"):
            dense(f"{pre}.mhsa.{name}", att[name])  # (d, H, dh) -> (d, d)
        h, dh, _ = np.shape(att["out"]["kernel"])
        dense(f"{pre}.mhsa.out", att["out"], flat_in=h * dh)
        cm = blk["ConvModule_0"]
        layer_norm(f"{pre}.conv.ln0", cm["LayerNorm_0"])
        dense(f"{pre}.conv.pw1", cm["Dense_0"])
        sd[f"{pre}.conv.dw.weight"] = _t(
            np.transpose(cm["Conv_0"]["kernel"], (2, 1, 0)))
        sd[f"{pre}.conv.dw.bias"] = _t(cm["Conv_0"]["bias"])
        layer_norm(f"{pre}.conv.ln1", cm["LayerNorm_1"])
        dense(f"{pre}.conv.pw2", cm["Dense_1"])
        layer_norm(f"{pre}.ln", blk["LayerNorm_0"])
        i += 1
    dense("out", p["Dense_0"])
    return sd


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
