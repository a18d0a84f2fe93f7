"""The model operations an utterance needs, counted from its shapes.

Matrix products, convolutions and attention, two operations a
multiply-add, on the utterance's own frames (no padding).  A training
step costs three forward passes (the forward, and the backward's two
products a forward product).  Elementwise work, normalisation, softmax,
the FFT and the lattice recursions are left out, so the count is a floor.
"""

from __future__ import annotations


def frames(num_samples: int, cfg: dict) -> tuple:
    """(feature frames, after the first conv, encoder frames) of a clip."""
    f = 1 + max(0, num_samples - cfg["n_fft"]) // cfg["hop_length"]
    t1 = (f + 1) // 2
    return f, t1, (t1 + 1) // 2


def encoder_forward(num_samples: int, cfg: dict, out_dim: int) -> float:
    f, t1, t = frames(num_samples, cfg)
    d, e = cfg["d_model"], cfg["ff_expansion_factor"] * cfg["d_model"]
    ch, mels, k = (cfg["subsampling_conv_channels"], cfg["n_mels"],
                   cfg["conv_kernel_size"])
    m1 = (mels + 1) // 2
    m2 = (m1 + 1) // 2
    ops = 2.0 * f * (cfg["n_fft"] // 2 + 1) * mels          # mel filterbank
    ops += 2.0 * t1 * m1 * ch * 9                             # conv0
    ops += 2.0 * t * m2 * ch * 9 * ch                         # conv1
    ops += 2.0 * t * m2 * ch * d                              # dense
    per_frame = 2.0 * (2 * 2 * d * e        # two feed-forward modules
                       + 4 * d * d          # q, k, v, out
                       + 2 * d * d + k * d + d * d)  # pw1, depthwise, pw2
    ops += cfg["num_layers"] * (t * per_frame + 2.0 * 2 * t * t * d)
    return ops + 2.0 * t * d * out_dim


def ctc_forward(num_samples: int, cfg: dict) -> float:
    return encoder_forward(num_samples, cfg, cfg["vocab_size"])


def transducer_forward(num_samples: int, pieces: int, cfg: dict) -> float:
    _, _, t = frames(num_samples, cfg)
    f, j, v = cfg["enc_dim"], cfg["joint_hidden"], cfg["vocab_size"]
    e, h = cfg["pred_emb_dim"], cfg["pred_hidden"]
    ops = encoder_forward(num_samples, cfg, f)
    ops += 2.0 * pieces * 3 * (e + h) * h             # the GRU's gates
    ops += 2.0 * t * f * j + 2.0 * (pieces + 1) * h * j
    return ops + 2.0 * t * (pieces + 1) * j * v       # the joint's output


def forward(num_samples: int, pieces: int, cfg: dict) -> float:
    if cfg["model"] == "transducer":
        return transducer_forward(num_samples, pieces, cfg)
    return ctc_forward(num_samples, cfg)
