"""The Conformer-Transducer: the encoder, a GRU predictor and an additive
joint, and the transducer loss.

    h_0 = 0;  x = emb[y_u];  z = sigmoid([x, h] Wz + bz);
    r = sigmoid([x, h] Wr + br);  c = tanh([x, r * h] Wh + bh);
    h_{u+1} = (1 - z) h_u + z c
    logits(t, u) = tanh(f_t W_enc + h_u W_pred + b) W_out + b_out

The loss is the batch mean of -log p(y | x), p summed over every
monotonic path through the (T, U + 1) lattice, log p(blank) moving t and
log p(y_{u+1}) moving u; the lattice recursion runs in float64 over its
anti-diagonals, and autograd takes it back.
"""

from __future__ import annotations

import math

import torch

from . import conformer, frontend

_NEG = -1e30  # log-zero that keeps logaddexp's gradient finite


def spec(cfg: dict):
    v, e = cfg["vocab_size"], cfg["pred_emb_dim"]
    h, j, f = cfg["pred_hidden"], cfg["joint_hidden"], cfg["enc_dim"]
    out = conformer.encoder_spec("encoder.", cfg, f)
    out.append(("pred.emb", (v, e), ("normal", 1.0)))  # nn.Embedding's
    for g in ("z", "r", "h"):
        out.append((f"pred.w{g}", (e + h, h),
                    ("normal", 0.5 / math.sqrt(e + h))))
        out.append((f"pred.b{g}", (h,), ("zeros",)))
    out.append(("pred.wo", (h, v), ("normal", 0.5 / math.sqrt(h))))
    out.append(("pred.bo", (v,), ("zeros",)))
    out.append(("joint.w_enc", (f, j), ("normal", 1 / math.sqrt(f))))
    out.append(("joint.w_pred", (h, j), ("normal", 1 / math.sqrt(h))))
    out.append(("joint.b", (j,), ("zeros",)))
    out.append(("joint.w_out", (j, v), ("normal", 1 / math.sqrt(j))))
    out.append(("joint.b_out", (v,), ("zeros",)))
    return out


def prefix_states(w, targets, p):
    """(N, U) ids -> (N, U + 1, H): h_0 and the state after each id."""
    n = targets.shape[0]
    h = targets.new_zeros((n, w["pred.wz"].shape[1]), dtype=torch.float32)
    hs = [h]
    for u in range(targets.shape[1]):
        x = w["pred.emb"][targets[:, u].long()]
        xh = torch.cat([x, h], -1)
        z = torch.sigmoid(p.mm(xh, w["pred.wz"]) + w["pred.bz"])
        r = torch.sigmoid(p.mm(xh, w["pred.wr"]) + w["pred.br"])
        c = torch.tanh(p.mm(torch.cat([x, r * h], -1), w["pred.wh"])
                       + w["pred.bh"])
        h = (1.0 - z) * h + z * c
        hs.append(h)
    return torch.stack(hs, 1)


def nll(blank_pl, label_pl, t_len, u_len):
    """(N,) -log p(y | x) from (N, T, U + 1) float64 planes."""
    n, t_max, up = blank_pl.shape
    dev = blank_pl.device
    u = torch.arange(up, device=dev)
    neg = torch.full((n, 1), _NEG, dtype=blank_pl.dtype, device=dev)
    alphas = []
    for d in range(t_max + up - 1):
        t = d - u
        inside = (t >= 0) & (t < t_max)
        if d == 0:
            a = torch.where(u == 0, 0.0, _NEG).to(blank_pl.dtype).expand(n, up)
        else:
            prev = alphas[-1]
            tb = t - 1  # (t - 1, u) --blank--> (t, u)
            from_b = prev + blank_pl[:, tb.clamp(0, t_max - 1), u]
            from_b = torch.where((tb >= 0) & (tb < t_max), from_b, _NEG)
            tc = t[1:].clamp(0, t_max - 1)  # (t, u - 1) --label--> (t, u)
            from_l = prev[:, :-1] + label_pl[:, tc, u[:-1]]
            from_l = torch.cat([neg, from_l], 1)
            a = torch.where(inside, torch.logaddexp(from_b, from_l), _NEG)
        alphas.append(a)
    alphas = torch.stack(alphas, 1)
    rows = torch.arange(n, device=dev)
    t_last, u_last = t_len.long() - 1, u_len.long()
    final = (alphas[rows, t_last + u_last, u_last]
             + blank_pl[rows, t_last, u_last])
    return -final


def loss(w, cfg, wave, num_samples, targets, target_lengths, p):
    """The training objective (batch mean), float64."""
    feats = frontend.log_mel(wave, cfg, p)
    frames = frontend.num_frames(num_samples, cfg["n_fft"], cfg["hop_length"])
    enc, t_len = conformer.encode(w, "encoder.", feats, frames, cfg, p)
    pred = prefix_states(w, targets, p)
    hidden = torch.tanh(p.mm(enc, w["joint.w_enc"])[:, :, None]
                        + p.mm(pred, w["joint.w_pred"])[:, None]
                        + w["joint.b"])
    logits = p.mm(hidden, w["joint.w_out"]) + w["joint.b_out"]
    lp = torch.log_softmax(logits, dim=-1)
    blank = cfg["blank"]
    y = torch.nn.functional.pad(targets.long(), (0, 1))  # (N, U + 1)
    label = lp.gather(3, y[:, None, :, None].expand(-1, lp.shape[1], -1, 1))
    return nll(lp[..., blank].double(), label[..., 0].double(), t_len,
               target_lengths).mean()
