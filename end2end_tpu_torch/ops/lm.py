"""Shallow-fusion language models for the beam decoder (torch port of the
dense and word-bigram LMs of `end2end_tpu/ops/lm.py`).

An LM is a set of tensors on one device (`device=`, CUDA by default, see
utils/device.py) queried with gathers; its per-hypothesis state is a tensor
(or a tuple of tensors) with one row per hypothesis.  Protocol, as in JAX:

  init_state(M) -> state                       M rows
  score(state, ck) -> (lm_lp (W, K), state_ext)   ck (K,) candidate tokens
      of all W rows, or (W, K) each row's own (the batched scan of
      ops/beam_search.py flattens N sequences' beams into W = N * beam
      rows)
  select(state, state_ext, parent, kk, is_stay) -> state
  final(state) -> (M,) end-of-sequence bonus
  score_chunk(state, toks) -> (lp_sum (M,), state)   toks (M, C), -1
      padded at the end: the vectorised replay of the chunked decode
      (ops/beam_chunked.py) and of rescoring (ops/rescore.py); equal to
      folding score/select over the tokens in order.

The decoder adds `alpha * lm_lp + beta` per emitted token.

Ported: `NGramLM` (dense bigram), `UniformLM`, `bigram_from_counts`,
`QuantizedBigramGuide` (class-keyed guide for in-kernel steering) and
`WordNGramLM` (word bigram over a separator or a BPE word-starter set).
The word hash table is a sorted key tensor searched with
`torch.searchsorted`; the TPU's cuckoo/bucket layouts (`_FastTable`) and its
packed replay worklist (`_word_score_packed`) are not ported: they exist
for the TPU's gather costs.  The hashed n-gram LMs, `HotwordBoostLM`,
`CompositeLM` and `NeuralLM` are not ported yet (ROADMAP.md queue 1,
item 5).

Rolling hashes are uint32 with wraparound, held in int64 tensors in
[0, 2**32) and reduced with `& 0xFFFFFFFF` after every step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .indexing import compact_rows, flat_take

_U32 = 0xFFFFFFFF
_INV31 = pow(31, -1, 1 << 32)  # 31 is odd, hence invertible mod 2**32


def _mul32(a, b):
    """a * b mod 2**32 for uint32 values held in int64 (tensors or ints);
    split at 16 bits so no product leaves int64."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def _pow_bits(exp: torch.Tensor, base: int, n_max: int) -> torch.Tensor:
    """base**exp mod 2**32 for integer exp in [0, n_max], by
    square-and-multiply over exp's bits."""
    x = torch.ones_like(exp)
    sq = int(base) & _U32
    for i in range(max(int(n_max).bit_length(), 1)):
        x = torch.where((exp >> i) & 1 == 1, _mul32(x, sq), x)
        sq = sq * sq & _U32
    return x


def _at_last_flag(flag: torch.Tensor, vals):
    """Per position j (inclusive): each val's value at the most recent
    flagged position <= j (0 where there is none yet), and whether one
    was seen."""
    pos = torch.arange(flag.shape[1], device=flag.device).expand_as(flag)
    last = torch.where(flag, pos, -1).cummax(dim=1).values
    seen = last >= 0
    idx = last.clamp(min=0)
    return seen, tuple(torch.where(seen, v.gather(1, idx), 0) for v in vals)


def _shift1(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], dim=1)


def _chunk_words(toks, space_id, curh, curlen, mult, seed):
    """Word segmentation of emitted-token chunks, vectorised over rows.

    The rolling hash h = h0*m^L + sum_i (c_i+1)*m^(L-1-i) equals
    m^L * (h0 + sum_i (c_i+1)*inv_m^(i+1)) because m is odd, so each
    word's hash is a segmented sum of position-weighted terms: cumulative
    sums plus the values at the previous separator.

    toks (M, C) tokens in order, -1 padded at the end; curh/curlen (M,) the
    carried partial word.  Returns whash (M, C//2+1) spell hashes of the
    completed words, left-justified, n_words (M,), and the new carry
    new_curh / new_curlen.
    """
    m, c = toks.shape
    w_max = c // 2 + 1
    inv = _INV31 if mult == 31 else pow(int(mult), -1, 1 << 32)
    valid = toks >= 0
    space = valid & (toks == space_id)
    char = valid & ~space

    cc = torch.cumsum(char.long(), dim=1)  # chars so far (inclusive)
    u = _mul32((toks.long() + 1) & _U32, _pow_bits(cc, inv, c))
    cs = torch.cumsum(torch.where(char, u, 0), dim=1) & _U32

    sp_seen, (cc_sp, cs_sp) = _at_last_flag(space, (cc, cs))
    seg0 = ~_shift1(sp_seen)  # no separator strictly before
    cc_prev, cs_prev = _shift1(cc_sp), _shift1(cs_sp)

    seg_len = cc - cc_prev  # at a separator: chars of the chunk part
    tot_len = seg_len + torch.where(seg0, curlen[:, None], 0)
    is_word = space & (tot_len > 0)
    base = torch.where(seg0, curh[:, None], seed)
    whash_at = (_mul32(_pow_bits(seg_len, mult, c), base)
                + _mul32(_pow_bits(cc, mult, c), (cs - cs_prev) & _U32)) & _U32

    n_words = is_word.sum(dim=1)
    whash = compact_rows(torch.where(is_word, whash_at, 0), fill=0,
                         valid=is_word)[:, :w_max]

    any_sp = sp_seen[:, -1]
    cc_end, cs_end = cc[:, -1], cs[:, -1]
    tl_chars = cc_end - torch.where(any_sp, cc_sp[:, -1], 0)
    cs_tail = (cs_end - torch.where(any_sp, cs_sp[:, -1], 0)) & _U32
    base_tr = torch.where(any_sp, seed, curh)
    new_curh = (_mul32(_pow_bits(tl_chars, mult, c), base_tr)
                + _mul32(_pow_bits(cc_end, mult, c), cs_tail)) & _U32
    new_curlen = tl_chars + torch.where(any_sp, 0, curlen)
    return dict(whash=whash, n_words=n_words, new_curh=new_curh,
                new_curlen=new_curlen)


_VSEP = 1 << 30  # virtual separator id for prefix-boundary interleaving


def _prefix_to_separator(toks, is_bnd):
    """Prefix-boundary (BPE) segmentation as separator segmentation: a
    virtual separator goes before each boundary token, which stays in the
    stream as part of its word.  (M, C) -> (M, 2C); -1 slots are invalid."""
    m, c = toks.shape
    sep = torch.where(is_bnd, _VSEP, -1)
    return torch.stack([sep, toks.long()], dim=2).reshape(m, 2 * c)


class _WordBoundaryMode:
    """Word boundaries: 'separator' (a token, e.g. space, ends a word and
    belongs to none; `space_id`) or 'prefix' (BPE word-starter tokens begin
    a word and belong to it; `boundary_ids`).  Exactly one is given."""

    def _init_boundary(self, space_id, boundary_ids, device):
        if (space_id is None) == (boundary_ids is None):
            raise ValueError(
                "exactly one of space_id (separator mode) and "
                "boundary_ids (prefix/BPE mode) must be given")
        # -10: matches no candidate id, including the -1 padding slots
        self._space = -10 if space_id is None else int(space_id)
        self._bnd = None
        if boundary_ids is not None:
            ids = sorted(int(i) for i in boundary_ids)
            if not ids or ids[0] < 0:
                raise ValueError("boundary_ids must be non-negative")
            mask = np.zeros(ids[-1] + 1, bool)
            mask[ids] = True
            self._bnd = torch.as_tensor(mask, device=device)

    def _is_boundary(self, ck):
        """Does token ck start (prefix mode) or end (separator mode) a
        word?"""
        if self._bnd is None:
            return ck == self._space
        n = self._bnd.shape[0]
        return self._bnd[ck.long().clamp(0, n - 1)] & (ck >= 0) & (ck < n)

    def _advance_word_hash(self, is_b, curh, curlen, ck):
        """Per-candidate hash and length (W, K) after appending ck, (K,)
        or (W, K): a separator resets to the empty word, a prefix boundary
        starts a new word containing the token."""
        cku = (ck.long() + 1) & _U32
        cont_h = (_mul32(curh[:, None], self._MULT) + cku) & _U32
        if self._bnd is None:
            new_h = torch.where(is_b, self._SEED, cont_h)
            new_len = torch.where(is_b, 0, curlen[:, None] + 1)
        else:
            restart = (self._SEED * self._MULT + cku) & _U32
            new_h = torch.where(is_b, restart, cont_h)
            new_len = torch.where(is_b, 1, curlen[:, None] + 1)
        return new_h, new_len

    def _segment_chunk(self, toks, curh, curlen):
        """_chunk_words under the configured boundary mode."""
        if self._bnd is None:
            return _chunk_words(toks, self._space, curh, curlen,
                                self._MULT, self._SEED)
        toks = _prefix_to_separator(toks, self._is_boundary(toks))
        return _chunk_words(toks, _VSEP, curh, curlen, self._MULT,
                            self._SEED)


class NGramLM:
    """Token-level bigram LM with a dense table.

    `table[prev, next] = log p(next | prev)`, with row V the start-of-
    sequence context.  State: the last token per hypothesis (-1 = empty).
    """

    def __init__(self, bigram_logp, start_logp=None, eos_logp=None, *,
                 device=None):
        """bigram_logp (V, V) log p(next | prev); start_logp (V,)
        log p(next | <s>) (default 0); eos_logp (V,) log p(</s> | last)
        (default 0)."""
        dev = resolve_device(device)
        bigram = torch.as_tensor(np.asarray(bigram_logp, np.float32))
        v = bigram.shape[0]
        start = (torch.zeros(v) if start_logp is None else
                 torch.as_tensor(np.asarray(start_logp, np.float32)))
        self._table = torch.cat([bigram, start[None]]).to(dev)
        self._eos = (torch.zeros(v) if eos_logp is None else torch.as_tensor(
            np.asarray(eos_logp, np.float32))).to(dev)
        self._v = v

    @property
    def device(self) -> torch.device:
        return self._table.device

    def init_state(self, m):
        return torch.full((m,), -1, dtype=torch.long, device=self.device)

    def score(self, state, ck):
        ctx = torch.where(state < 0, self._v, state)
        ck = ck.long()
        lm_lp = self._table[ctx[:, None], ck]  # (W, K)
        return lm_lp, ck.expand_as(lm_lp)

    def select(self, state, state_ext, parent, kk, is_stay):
        return torch.where(is_stay, state[parent], state_ext[parent, kk])

    def final(self, state):
        last = state.clamp(0, self._v - 1)
        return torch.where(state >= 0, self._eos[last], 0.0)

    def score_chunk(self, state, toks):
        toks = toks.long()
        valid = toks >= 0
        prev = torch.cat([state[:, None], toks[:, :-1]], dim=1)
        ctx = torch.where(prev < 0, self._v, prev)
        lp = self._table.reshape(-1)[ctx * self._v
                                     + toks.clamp(0, self._v - 1)]
        lp_sum = torch.where(valid, lp, 0.0).sum(dim=1)
        n_valid = valid.sum(dim=1)
        last_tok = flat_take(toks, (n_valid - 1).clamp(min=0)[:, None])[:, 0]
        return lp_sum, torch.where(n_valid > 0, last_tok, state)


class UniformLM(NGramLM):
    """Every token scores `logp` (with alpha, a per-token length bonus)."""

    def __init__(self, vocab_size, logp=0.0, *, device=None):
        super().__init__(np.full((vocab_size, vocab_size), logp, np.float32),
                         device=device)


def bigram_from_counts(counts, smoothing: float = 1.0):
    """Dense bigram log-probs from a (V, V) count matrix (add-k smoothing)."""
    counts = np.asarray(counts, np.float64) + smoothing
    probs = counts / counts.sum(axis=1, keepdims=True)
    return np.log(probs).astype(np.float32)


class QuantizedBigramGuide:
    """Class-keyed dense bigram for in-kernel steering at any vocabulary.

    `cls_map` sends each token to one of n_classes context classes and
    `table[c, k]` approximates log p(k | a context of class c); row
    n_classes is the exact start-of-sequence row.  The beam kernel tracks
    the class of each beam's last symbol (csrc/beam_step.cu, class-keyed
    mode), so the context rows stay <= 64 whatever V is.  A guide only
    steers pruning between chunk boundaries: the chunked decode replaces
    its bonus with the exact `lm`'s at every boundary.
    """

    def __init__(self, cls_map, table, *, device=None):
        dev = resolve_device(device)
        self._cls_map = torch.as_tensor(np.asarray(cls_map, np.int32)).to(dev)
        self._table = torch.as_tensor(np.asarray(table, np.float32)).to(dev)
        self._v = int(self._cls_map.shape[0])
        self._n_classes = int(self._table.shape[0]) - 1
        if self._table.shape[1] != self._v:
            raise ValueError(f"table columns ({self._table.shape[1]}) must "
                             f"match cls_map length ({self._v})")
        if (int(self._cls_map.max()) >= self._n_classes
                or int(self._cls_map.min()) < 0):
            raise ValueError("cls_map values must lie in [0, n_classes)")

    @property
    def device(self) -> torch.device:
        return self._table.device

    @classmethod
    def from_bigram(cls, lm, n_classes: int = 63, iters: int = 10,
                    seed: int = 0, max_cols: int = 1024,
                    floor: float = -30.0, *, device=None):
        """Quantise an `NGramLM`'s context rows by k-means (build-time
        NumPy, the JAX package's algorithm and random draws, so a seed
        gives the same classes).  Rows are floored at `floor`, distances
        taken on at most `max_cols` random columns, class rows are the
        full-width means of their members; the start row stays exact.
        The guide lives on `device`, by default the LM's."""
        if not isinstance(lm, NGramLM):
            raise ValueError("from_bigram takes a dense NGramLM")
        v = lm._v
        n_classes = int(min(n_classes, v))
        table = lm._table.cpu().numpy()
        X = np.maximum(table[:v], floor)
        rng = np.random.default_rng(seed)
        cols = (np.arange(v) if v <= max_cols
                else rng.choice(v, max_cols, replace=False))
        Xd = X[:, cols]
        cent = Xd[rng.choice(v, n_classes, replace=False)]
        assign = np.zeros(v, np.int64)
        for _ in range(int(iters)):
            d = ((Xd[:, None, :] - cent[None]) ** 2).sum(-1) \
                if v * n_classes * len(cols) < (1 << 27) else None
            if d is None:  # blockwise distances at large V
                d = np.empty((v, n_classes), np.float32)
                x2 = (Xd ** 2).sum(1)
                for c0 in range(0, n_classes, 16):
                    cc = cent[c0:c0 + 16]
                    d[:, c0:c0 + 16] = (x2[:, None]
                                        - 2.0 * Xd @ cc.T
                                        + (cc ** 2).sum(1)[None])
            assign = d.argmin(1)
            for c in range(n_classes):
                m = assign == c
                if m.any():
                    cent[c] = Xd[m].mean(0)
                else:  # reseed empty clusters to the farthest point
                    far = int(d.min(1).argmax())
                    cent[c] = Xd[far]
                    assign[far] = c
        rows = np.zeros((n_classes + 1, v), np.float32)
        for c in range(n_classes):
            m = assign == c
            rows[c] = X[m].mean(0) if m.any() else floor
        rows[n_classes] = np.maximum(table[v], floor)
        return cls(assign.astype(np.int32), rows,
                   device=lm.device if device is None else device)


class _WordHash:
    """Spell hash -> word id: a sorted key tensor and `torch.searchsorted`,
    with a miss check.  Two words with the same spell hash raise (their
    ids would be conflated)."""

    _MULT = 31
    _SEED = 5381

    def __init__(self, word_spellings, miss_value, device):
        self.miss = int(miss_value)
        keys = []
        for spell in word_spellings:
            h = self._SEED
            for c in spell:
                h = (h * self._MULT + int(c) + 1) & _U32
            keys.append(h)
        keys = np.asarray(keys, np.int64)
        order = np.argsort(keys, kind="stable")
        srt = keys[order]
        dup = np.nonzero(srt[1:] == srt[:-1])[0]
        if dup.size:
            raise ValueError(f"hash collision for key {int(srt[dup[0]]):#x}")
        self._keys = torch.as_tensor(srt, device=device)
        self._ids = torch.as_tensor(order, device=device)

    def lookup(self, h):
        """Spell hashes (any shape, int64 uint32 values) -> word ids
        (miss_value on a miss)."""
        if self._keys.numel() == 0:
            return torch.full_like(h, self.miss)
        pos = torch.searchsorted(self._keys, h.contiguous())
        pos = pos.clamp(max=self._keys.numel() - 1)
        return torch.where(self._keys[pos] == h, self._ids[pos], self.miss)


class WordNGramLM(_WordBoundaryMode):
    """Word-bigram shallow fusion, scored each time a word completes (at a
    boundary and at the end of the utterance), as the reference's KenLM
    hook does.

    State per hypothesis: (previous word id, rolling hash of the word being
    typed, its length).  Word ids come from the spell hash (`_WordHash`);
    unknown words score `unk_logp` and condition as <unk>.
    """

    _MULT = 31
    _SEED = 5381

    def __init__(self, word_spellings, bigram_logp, start_logp, space_id,
                 unigram_logp=None, eos_logp=None, unk_logp=-13.8,
                 boundary_ids=None, *, device=None):
        """word_spellings: token-id tuples per word (in prefix mode each
        starts with its boundary token); bigram_logp (Wv, Wv); start_logp
        (Wv,); eos_logp (Wv,) optional; space_id: the separator id, or
        None with `boundary_ids` (prefix/BPE mode)."""
        dev = resolve_device(device)
        wv = len(word_spellings)
        self._wv = wv
        self._init_boundary(space_id, boundary_ids, dev)
        self._unk = wv + 1  # context row for unknown words; wv = <s>
        if unigram_logp is None:
            unigram_logp = np.full((wv,), unk_logp, np.float32)
        # rows = context (words, <s>, <unk>); cols = next word (words, <unk>)
        ext = np.full((wv + 2, wv + 1), unk_logp, np.float32)
        ext[:wv, :wv] = np.asarray(bigram_logp, np.float32)
        ext[wv, :wv] = np.asarray(start_logp, np.float32)
        ext[wv + 1, :wv] = np.asarray(unigram_logp, np.float32)
        self._table = torch.as_tensor(ext, device=dev)
        eos = np.zeros((wv + 2,), np.float32)
        if eos_logp is not None:
            eos[:wv] = np.asarray(eos_logp, np.float32)
        self._eos = torch.as_tensor(eos, device=dev)
        self._wh = _WordHash(word_spellings, self._unk, dev)
        self._unk_logp = float(unk_logp)

    @property
    def device(self) -> torch.device:
        return self._table.device

    @classmethod
    def from_arpa(cls, path, words, alphabet=None, space_symbol=" ",
                  spellings=None, boundary_ids=None, **kw):
        """words: word strings; alphabet: anything with `encode(str) ->
        token ids`.  For subword (BPE) models pass `spellings` (token-id
        tuples per word, each starting with its boundary token) and
        `boundary_ids` instead of an alphabet."""
        from ..utils.arpa import load_arpa

        uni, bigram, start, eos = load_arpa(path, list(words))
        if spellings is None:
            spellings = [tuple(alphabet.encode(w)) for w in words]
        space_id = (None if boundary_ids is not None
                    else alphabet.encode(space_symbol)[0])
        return cls(spellings, bigram, start, space_id, unigram_logp=uni,
                   eos_logp=eos, boundary_ids=boundary_ids, **kw)

    def _word_lp(self, prev, wid):
        lp = self._table[prev, wid.clamp(max=self._wv)]
        return torch.where(wid == self._unk, self._unk_logp, lp)

    def init_state(self, m):
        dev = self.device
        return (torch.full((m,), self._wv, dtype=torch.long, device=dev),
                torch.full((m,), self._SEED, dtype=torch.long, device=dev),
                torch.zeros((m,), dtype=torch.long, device=dev))

    def score(self, state, ck):
        prev, curh, curlen = state
        is_b = self._is_boundary(ck)  # (K,) or (W, K)
        wid = self._wh.lookup(curh)  # the word a boundary would complete
        complete = torch.where(curlen > 0, self._word_lp(prev, wid), 0.0)
        lm_lp = torch.where(is_b, complete[:, None], 0.0)  # (W, K)
        ended = torch.where(curlen > 0, wid, prev)[:, None]
        new_prev = torch.where(is_b, ended, prev[:, None])
        new_hash, new_len = self._advance_word_hash(is_b, curh, curlen, ck)
        return lm_lp, (new_prev, new_hash, new_len)

    def select(self, state, state_ext, parent, kk, is_stay):
        return tuple(torch.where(is_stay, s[parent], se[parent, kk])
                     for s, se in zip(state, state_ext))

    def final(self, state):
        """Complete the trailing word, then add log p(</s> | last word)."""
        prev, curh, curlen = state
        wid = self._wh.lookup(curh)
        trailing = torch.where(curlen > 0, self._word_lp(prev, wid), 0.0)
        ended = torch.where(curlen > 0, wid, prev)
        return trailing + self._eos[ended.clamp(max=self._wv + 1)]

    def score_chunk(self, state, toks):
        """Words completed inside the chunk are found with _chunk_words and
        scored in sequence order, one word column at a time (vectorised
        over rows, up to the chunk's largest word count)."""
        prev, curh, curlen = state
        seg = self._segment_chunk(toks, curh, curlen)
        whash, n_words = seg["whash"], seg["n_words"]
        lp_sum = torch.zeros(toks.shape[0], device=toks.device)
        n_max = int(n_words.max()) if toks.shape[0] else 0
        for j in range(n_max):
            live = j < n_words
            wid = self._wh.lookup(whash[:, j])
            lp_sum = lp_sum + torch.where(live, self._word_lp(prev, wid), 0.0)
            prev = torch.where(live, wid, prev)
        return lp_sum, (prev, seg["new_curh"], seg["new_curlen"])
