"""Pure-NumPy float64 reference for the RNN-T (transducer) loss (the torch
port's copy of `end2end_tpu/utils/rnnt_reference.py`, the same names and
arithmetic; it imports only numpy, so it runs wherever the port does).

The oracle the transducer kernels K8/K9 and their plain versions are held
to.  Math: Graves 2012, "Sequence Transduction with Recurrent Neural
Networks" (arXiv:1211.3711).

Lattice: nodes (t, u), t in [0, T), u in [0, U]; U = target length.
From (t, u):
  * emit blank  -> (t+1, u) with log-prob  lp[t, u, blank]   (consume frame)
  * emit y[u]   -> (t, u+1) with log-prob  lp[t, u, y[u]]    (emit label)
Termination: the final blank out of (T-1, U).

  alpha[0, 0] = 0
  alpha[t, u] = logaddexp(alpha[t-1, u] + lp[t-1, u, blank],
                          alpha[t, u-1] + lp[t, u-1, y[u-1]])
  logZ = alpha[T-1, U] + lp[T-1, U, blank];  loss = -logZ

  beta[t, u] = log P(termination | at (t, u)), INCLUSIVE of the emissions
  taken at (t, u):
  beta[T-1, U] = lp[T-1, U, blank]
  beta[t, u]   = logaddexp(lp[t, u, blank] + beta[t+1, u],
                           lp[t, u, y[u]]  + beta[t, u+1])
  (out-of-grid successors contribute -inf; logZ == beta[0, 0] == alpha+beta
  identity along every anti-diagonal.)

  Gradient wrt the LOG-PROBS (each (t, u) slice independently normalized):
  grad_lp[t, u, v] = -( [v == blank] * exp(alpha[t,u] + lp[t,u,blank]
                                            + beta_next_t - logZ)
                      + [v == y[u]]  * exp(alpha[t,u] + lp[t,u,y[u]]
                                            + beta_next_u - logZ) )
  where beta_next_t = beta[t+1, u] (0 at the terminal node (T-1, U)) and
  beta_next_u = beta[t, u+1].

  Gradient wrt LOGITS (lp = log_softmax(logits)):
  grad_logits[t, u, v] = softmax(logits)[t,u,v] * occ(t, u) + grad_lp[t,u,v]
  with occupancy occ(t, u) = exp(alpha[t,u] + beta[t,u] - logZ) —
  the transducer analog of CTC's fused ``exp(lp) - posterior``
  (SURVEY.md §4.2), scaled by how much probability mass passes through
  the (t, u) node.
"""

from __future__ import annotations

import itertools

import numpy as np

NEG_INF = -np.inf


def _logaddexp(a, b):
    return np.logaddexp(a, b)


def rnnt_loss_ref(log_probs, targets, input_lengths, target_lengths,
                  blank=0):
    """Per-sample transducer NLL + gradient wrt log_probs, float64 loops.

    Args:
      log_probs: (N, T, U+1, V) float array, log-softmaxed over V per
        (t, u) node (torchaudio ``rnnt_loss`` logits layout, post-softmax).
      targets: (N, U) padded int labels.
      input_lengths: (N,) frames per sample (<= T).
      target_lengths: (N,) labels per sample (<= U).
      blank: blank id.

    Returns:
      (losses (N,), grads (N, T, U+1, V)) float64; grads wrt log_probs.
      Padded (t >= T_n or u > U_n) slices get zero grad.
    """
    lp = np.asarray(log_probs, np.float64)
    n, t_max, u_pad, v = lp.shape
    targets = np.asarray(targets)
    losses = np.zeros(n)
    grads = np.zeros_like(lp)
    for b in range(n):
        T = int(input_lengths[b])
        U = int(target_lengths[b])
        y = targets[b, :U].astype(np.int64)
        alpha = np.full((T, U + 1), NEG_INF)
        alpha[0, 0] = 0.0
        for t in range(T):
            for u in range(U + 1):
                acc = alpha[t, u] if (t, u) == (0, 0) else NEG_INF
                if t > 0:
                    acc = _logaddexp(acc, alpha[t - 1, u] + lp[b, t - 1, u,
                                                              blank])
                if u > 0:
                    acc = _logaddexp(acc, alpha[t, u - 1] + lp[b, t, u - 1,
                                                               y[u - 1]])
                alpha[t, u] = acc
        log_z = alpha[T - 1, U] + lp[b, T - 1, U, blank]
        losses[b] = -log_z

        beta = np.full((T, U + 1), NEG_INF)
        beta[T - 1, U] = lp[b, T - 1, U, blank]
        for t in range(T - 1, -1, -1):
            for u in range(U, -1, -1):
                if (t, u) == (T - 1, U):
                    continue
                acc = NEG_INF
                if t + 1 < T:
                    acc = _logaddexp(acc, lp[b, t, u, blank] + beta[t + 1, u])
                if u < U:
                    acc = _logaddexp(acc, lp[b, t, u, y[u]] + beta[t, u + 1])
                beta[t, u] = acc

        if not np.isfinite(log_z):
            continue  # impossible (U > T not possible here; degenerate lp)
        for t in range(T):
            for u in range(U + 1):
                if not np.isfinite(alpha[t, u]):
                    continue
                b_next = beta[t + 1, u] if t + 1 < T else (
                    0.0 if u == U else NEG_INF)
                g_blank = np.exp(alpha[t, u] + lp[b, t, u, blank] + b_next
                                 - log_z)
                grads[b, t, u, blank] -= g_blank
                if u < U:
                    g_lab = np.exp(alpha[t, u] + lp[b, t, u, y[u]]
                                   + beta[t, u + 1] - log_z)
                    grads[b, t, u, y[u]] -= g_lab
    return losses, grads


def rnnt_logits_grad_ref(logits, targets, input_lengths, target_lengths,
                         blank=0):
    """Loss + gradient wrt raw LOGITS (fused log_softmax), float64.

    grad_logits = softmax(logits) * occupancy(t, u) + grad_lp  (see module
    docstring) — verified against finite differences and a torch-autograd
    twin in the JAX package's tests/test_rnnt.py.
    """
    logits = np.asarray(logits, np.float64)
    m = logits.max(axis=-1, keepdims=True)
    lse = m + np.log(np.exp(logits - m).sum(axis=-1, keepdims=True))
    lp = logits - lse
    losses, grad_lp = rnnt_loss_ref(lp, targets, input_lengths,
                                    target_lengths, blank)
    # occupancy = total posterior mass leaving (t, u) = -sum_v grad_lp[t,u,:]
    occ = -grad_lp.sum(axis=-1, keepdims=True)
    grads = np.exp(lp) * occ + grad_lp
    return losses, grads


def rnnt_loss_paths(log_probs, target, blank=0):
    """Brute-force transducer NLL by exhaustive path enumeration (single
    sample) — the independent tiny-shape oracle (no shared DP structure).

    A monotone lattice path from (0,0) to the terminal is a choice of WHICH
    frame emits each label: u-th label emitted at frame f_u with
    f_0 <= f_1 <= ... (labels in order, multiple per frame allowed); every
    other step is a blank.  Enumerates all C(T+U, U)-ish assignments.
    """
    lp = np.asarray(log_probs, np.float64)
    t_max, u_pad, v = lp.shape
    y = np.asarray(target, np.int64)
    U = len(y)
    total = NEG_INF
    for frames in itertools.combinations_with_replacement(range(t_max), U):
        s = 0.0
        u = 0
        for t in range(t_max):
            while u < U and frames[u] == t:
                s += lp[t, u, y[u]]
                u += 1
            s += lp[t, u, blank]  # the frame-advancing blank (incl. final)
        total = _logaddexp(total, s)
    return -total
