"""The model operations a Parakeet (FastConformer transducer) utterance
needs, counted from its shapes as `flops` counts the Conformer's: products,
convolutions and attention, two operations a multiply-add, on the
utterance's own frames, a training step three forward passes.  Beside
`flops`'s terms: the depthwise-separable subsampler, each block's
positional projection of the 2T'-1 offsets and the (q + v) . p product
over them, the LSTM's four gates a layer, and the joint's two
projections and output (the ReLU, like the tanh, is elementwise and left
out)."""

from __future__ import annotations

import math


def frames(num_samples: int, cfg: dict) -> list:
    """[feature frames, then the frames after each stride-2 stage]."""
    out = [1 + max(0, num_samples - cfg["n_fft"]) // cfg["hop_length"]]
    for _ in range(int(math.log2(cfg["subsampling_factor"]))):
        out.append((out[-1] + 1) // 2)
    return out


def encoder_forward(num_samples: int, cfg: dict, out_dim: int) -> float:
    fr = frames(num_samples, cfg)
    t = fr[-1]
    d, e = cfg["d_model"], cfg["ff_expansion_factor"] * cfg["d_model"]
    ch, k = cfg["subsampling_conv_channels"], cfg["conv_kernel_size"]
    mels = [cfg["n_mels"]]
    for _ in fr[1:]:
        mels.append((mels[-1] + 1) // 2)
    ops = 2.0 * fr[0] * (cfg["n_fft"] // 2 + 1) * cfg["n_mels"]  # filterbank
    ops += 2.0 * fr[1] * mels[1] * ch * 9                       # conv0
    for ti, mi in zip(fr[2:], mels[2:]):
        ops += 2.0 * ti * mi * ch * (9 + ch)                    # dw + pw
    ops += 2.0 * t * mels[-1] * ch * d                          # dense
    per_frame = 2.0 * (2 * 2 * d * e        # two feed-forward modules
                       + 4 * d * d          # q, k, v, out
                       + 2 * d * d + k * d + d * d)  # pw1, depthwise, pw2
    per_block = (t * per_frame
                 + 2.0 * (2 * t - 1) * d * d       # linear_pos
                 + 2.0 * t * t * d                 # (q + u) . k
                 + 2.0 * t * (2 * t - 1) * d       # (q + v) . p, all offsets
                 + 2.0 * t * t * d)                # attention . v
    ops += cfg["num_layers"] * per_block
    return ops + 2.0 * t * d * out_dim


def forward(num_samples: int, pieces: int, cfg: dict) -> float:
    t = frames(num_samples, cfg)[-1]
    f, j, v = cfg["enc_dim"], cfg["joint_hidden"], cfg["vocab_size"]
    e, h = cfg["pred_emb_dim"], cfg["pred_hidden"]
    u = pieces + 1                                   # blank, y_1 .. y_U
    ops = encoder_forward(num_samples, cfg, f)
    ops += 2.0 * u * 4 * h * (e + h)                 # the LSTM's first layer
    ops += 2.0 * u * 4 * h * 2 * h * (cfg["pred_rnn_layers"] - 1)
    ops += 2.0 * t * f * j + 2.0 * u * h * j
    return ops + 2.0 * t * u * j * v                 # the joint's output
