"""CTC prefix beam search from its definition, on one utterance's float64
log-probs, with the served decoder's pruning rules:

  * each frame's candidates extend a prefix by one of the frame's `K` most
    probable symbols (a stable sort: the lower id first among equals);
  * a prefix ending in symbol c repeats it with p(c) only when c is among
    the frame's K + 8 most probable symbols;
  * an extension that recreates a live prefix is merged into it (its mass
    joins that prefix's non-blank mass) and is no candidate of its own;
  * the `W` best candidates survive, by log p(prefix), the earlier
    candidate first among equals (each beam's stay in rank order, then its
    extensions, beam by beam, slot by slot);
  * a prefix of `s_cap` symbols is not extended.

Returns every surviving prefix with its log p, best first.
"""

from __future__ import annotations

import numpy as np

_NEG = -np.inf


def prefix_beam_search(lp: np.ndarray, W: int, K: int, blank: int,
                       s_cap: int) -> list:
    t_max, v = lp.shape
    K = min(K, v)
    ks = min(K + 8, v)
    prefixes = [()]
    pb, pnb = np.array([0.0]), np.array([_NEG])
    for t in range(t_max):
        row = lp[t]
        order = np.argsort(-row, kind="stable")
        top = order[:K]
        window = np.zeros(v, bool)
        window[order[:ks]] = True
        n = len(prefixes)
        total = np.logaddexp(pb, pnb)
        last = np.array([p[-1] if p else -1 for p in prefixes])
        has = last >= 0
        rep = np.where(has & window[np.maximum(last, 0)],
                       row[np.maximum(last, 0)], _NEG)
        pb_stay = total + row[blank]
        pnb_stay = np.where(has, pnb + rep, _NEG)
        base = np.where(top[None, :] == last[:, None], pb[:, None],
                        total[:, None])
        ext = base + row[top][None, :]
        lens = np.array([len(p) for p in prefixes])
        ext[:, top == blank] = _NEG
        ext[lens >= s_cap] = _NEG
        index = {p: i for i, p in enumerate(prefixes)}
        for i, p in enumerate(prefixes):  # merge a child into its parent's
            j = index.get(p[:-1]) if p else None
            if j is None or lens[j] >= s_cap:
                continue
            ext[j, top == p[-1]] = _NEG
            if rep[i] > _NEG:
                b = pb[j] if last[j] == last[i] else total[j]
                pnb_stay[i] = np.logaddexp(pnb_stay[i], b + rep[i])
        stay = np.logaddexp(pb_stay, pnb_stay)
        scores = np.concatenate([stay, ext.reshape(-1)])
        codes = np.arange(scores.size)
        pick = [c for c in np.lexsort((codes, -scores))[:W]
                if scores[c] > _NEG]
        new_p, new_b, new_nb = [], [], []
        for c in pick:
            if c < n:
                new_p.append(prefixes[c])
                new_b.append(pb_stay[c])
                new_nb.append(pnb_stay[c])
            else:
                i, k = divmod(c - n, K)
                new_p.append(prefixes[i] + (int(top[k]),))
                new_b.append(_NEG)
                new_nb.append(ext[i, k])
        prefixes, pb, pnb = new_p, np.array(new_b), np.array(new_nb)
    return list(zip(prefixes, np.logaddexp(pb, pnb).tolist()))
