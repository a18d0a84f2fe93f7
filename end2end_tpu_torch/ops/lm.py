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
`QuantizedBigramGuide` (class-keyed guide for in-kernel steering),
`WordNGramLM` (word bigram over a separator or a BPE word-starter set), the
KenLM backoff core `_HashedNGramTables` behind `HashedNGramLM` (token
n-grams of any order) and `HashedWordNGramLM` (word n-grams of any order),
`HotwordBoostLM` (phrase boosting) and `CompositeLM` (a weighted sum of
LMs, its state the tuple of the members').  `NeuralLM` is in
ops/neural_lm.py.

Hash tables are sorted int64 key tensors searched with
`torch.searchsorted` (`_WordHash`, `_SortedTable`): a hashed n-gram or
hotword prefix is keyed by the JAX package's dual fold (h1, h2), so the
port hits and misses where JAX does, collisions included.  The TPU's
cuckoo/bucket layouts (`_FastTable`), its packed replay worklist
(`_word_score_packed`) and its rounds of 16 positions exist for the TPU's
gather costs and are not ported: `score_chunk` replays a chunk's token
positions at once, and a word LM's words one column at a time up to the
chunk's largest word count, vectorised over rows.

Rolling hashes are uint32 with wraparound, held in int64 tensors in
[0, 2**32) and reduced with `& 0xFFFFFFFF` after every step.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

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


def _where_rows(mask, a, b):
    """`torch.where` of two states (tensors or nests of tuples, lists and
    dicts of them) by a row mask, (M,) or (N, W), broadcast over each
    leaf's trailing dimensions."""
    return tree_map(lambda x, y: torch.where(
        mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())), x, y), a,
        b)


def _state_device(state) -> torch.device:
    return tree_leaves(state)[0].device


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

    def init_state(self, w):
        return torch.full((w,), -1, dtype=torch.long, device=self.device)

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

    def init_state(self, w):
        dev = self.device
        return (torch.full((w,), self._wv, dtype=torch.long, device=dev),
                torch.full((w,), self._SEED, dtype=torch.long, device=dev),
                torch.zeros((w,), dtype=torch.long, device=dev))

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


class _SortedTable:
    """Exact (h1, h2) -> payload lookups: the keys (h1 - 2**31) * 2**32 + h2
    (int64, in (h1, h2) order) sorted, searched with `torch.searchsorted`.

    items: [(h1, h2, payload tuple)], h1/h2 uint32 values.  A re-listed
    (h1, h2) overwrites the earlier payload; with `on_dup="error"` it
    raises instead (distinct items sharing (h1, h2) would be conflated).
    A miss reads payload 0.
    """

    def __init__(self, items, payload_width, on_dup="overwrite",
                 device=None):
        n = len(items)
        keys = np.fromiter(((int(h1) - (1 << 31)) * (1 << 32) + int(h2)
                            for h1, h2, _ in items), np.int64, n)
        pay = np.asarray([p for _, _, p in items],
                         np.float32).reshape(n, payload_width)
        order = np.argsort(keys, kind="stable")
        srt = keys[order]
        last = np.ones(n, bool)  # the last item listed of each key
        last[:-1] = srt[1:] != srt[:-1]
        if on_dup == "error" and not last.all():
            k = int(srt[np.nonzero(~last)[0][0]])
            h1 = (k >> 32) + (1 << 31)
            raise ValueError(f"hash collision for key {k & _U32:#x} "
                             f"(h1 {h1:#x})")
        self._keys = torch.as_tensor(srt[last], device=device)
        self._pay = torch.as_tensor(pay[order][last], device=device)

    def lookup(self, h1, h2):
        """(hit, [payload columns]) for int64 uint32-valued hashes (any
        shape, broadcast together)."""
        q = (h1 - (1 << 31)) * (1 << 32) + h2
        if self._keys.numel() == 0:
            zero = torch.zeros(q.shape, device=q.device)
            return (torch.zeros(q.shape, dtype=torch.bool, device=q.device),
                    [zero] * self._pay.shape[1])
        pos = torch.searchsorted(self._keys, q.contiguous())
        pos = pos.clamp(max=self._keys.numel() - 1)
        hit = self._keys[pos] == q
        return hit, [torch.where(hit, self._pay[pos, i], 0.0)
                     for i in range(self._pay.shape[1])]


class _HashedNGramTables:
    """N-gram scores and backoffs of any order with KenLM backoff semantics
    (the JAX package's `_HashedNGramTables`).

    Three routes, as in JAX:
      * when n_ids**order <= _FULL_MAX (char-scale vocabularies at order
        <= 3, any vocabulary up to ~1400 at order 2) the whole backoff
        recursion is resolved at build time into one dense score table
        over (context window, w), built in NumPy in `score`'s float32
        order, so its entries are bit-equal to the chain's;
      * otherwise unigrams are a dense (lp, bo, occupied) row per id, and
        bigrams too while n_ids <= 259;
      * the higher orders are hashed: each gram's dual fold (h1, h2) keys a
        `_SortedTable` of (lp, bo).
    Id rows: 0 = the unknown-word sentinel -2, 1 = the empty slot -1, the
    last row = out of range; these rows hold no gram and back off.
    """

    _M1 = 2654435761
    _M2 = 0x85EBCA6B
    _SEED1 = 0x9E3779B9
    _SEED2 = 0x85EBCA77
    _FULL_MAX = 1 << 21  # dense full-score entries cap (8 MB f32)

    def __init__(self, order, ngrams, unk_logp=None, dense_full=None,
                 device=None):
        """ngrams: {k: [(ids_tuple, logp, backoff)], 'unk': logp|None}, as
        `utils.arpa.parse_arpa_order` returns it.  dense_full: None = the
        dense full table when it fits _FULL_MAX entries; False = never
        (the hashed route); True = required (raises over the cap)."""
        self.order = int(order)
        self.unk_logp = float(
            unk_logp if unk_logp is not None
            else (ngrams.get("unk") if ngrams.get("unk") is not None
                  else -23.0))
        max_id = -1
        for k in range(1, self.order + 1):
            for ids, _, _ in ngrams.get(k, []):
                max_id = max(max_id, max(int(t) for t in ids))
        self._max_id = max_id
        n_ids = max_id + 4
        self._n_ids = n_ids
        fits = n_ids ** self.order <= self._FULL_MAX
        if dense_full and not fits:
            raise ValueError(
                f"dense_full requested but {n_ids}**{self.order} exceeds "
                f"the {self._FULL_MAX}-entry cap")
        self._full = self._uni = self._bi = None
        if fits and dense_full is not False:
            self._full = torch.as_tensor(self._build_full(ngrams, n_ids),
                                         device=device)
        else:
            uni = np.zeros((n_ids, 3), np.float32)
            for ids, lp, bo in ngrams.get(1, []):
                uni[int(ids[0]) + 2] = (lp, bo, 1.0)
            self._uni = torch.as_tensor(uni, device=device)
            if self.order >= 2 and n_ids <= 259:  # dense bigram <= ~800 KB
                bi = np.zeros((n_ids * n_ids, 3), np.float32)
                for ids, lp, bo in ngrams.get(2, []):
                    bi[(int(ids[0]) + 2) * n_ids + int(ids[1]) + 2] = (
                        lp, bo, 1.0)
                self._bi = torch.as_tensor(bi, device=device)
        self._tables = []
        for k in range(1, self.order + 1):
            if (self._full is not None or k == 1
                    or (k == 2 and self._bi is not None)):
                self._tables.append(None)  # served by a dense route
                continue
            items = [(*self._fold_np(ids), (lp, bo))
                     for ids, lp, bo in ngrams.get(k, [])]
            self._tables.append(_SortedTable(items, 2, device=device))
        self.device = torch.device("cpu" if device is None else device)

    def _build_full(self, ngrams, n):
        """The whole backoff recursion resolved into a flat (n**order,)
        float32 score table over id-row tuples (ctx oldest..newest, w),
        `score`'s float32 accumulation order replayed."""
        order = self.order
        lps, bos, occs = [], [], []
        for k in range(1, order + 1):
            lp = np.zeros((n,) * k, np.float32)
            bo = np.zeros((n,) * k, np.float32)
            oc = np.zeros((n,) * k, bool)
            for ids, l, b in ngrams.get(k, []):
                idx = tuple(int(t) + 2 for t in ids)
                lp[idx], bo[idx], oc[idx] = l, b, True
            lps.append(lp)
            bos.append(bo)
            occs.append(oc)

        def gram_w(k):  # k-gram ending in w: the last k grid axes
            sh = (1,) * (order - k) + (n,) * k
            return lps[k - 1].reshape(sh), occs[k - 1].reshape(sh)

        def gram_ctx(k):  # k-gram ending at the last ctx slot
            sh = (1,) * (order - 1 - k) + (n,) * k + (1,)
            return bos[k - 1].reshape(sh), occs[k - 1].reshape(sh)

        shape = (n,) * order
        acc = np.zeros(shape, np.float32)
        res = np.zeros(shape, np.float32)
        found = np.zeros(shape, bool)
        for k in range(order, 0, -1):
            lp, hit = gram_w(k)
            res = np.where(~found & hit, lp + acc, res)
            found = found | hit
            if k > 1:
                cbo, chit = gram_ctx(k - 1)
                acc = acc + np.where(chit, cbo, np.float32(0.0))
        return np.where(
            found, res, np.float32(self.unk_logp) + acc).reshape(-1)

    def _id_row(self, ids):
        """Token ids -> dense-table rows (sentinels and out-of-range ids
        -> rows that hold no gram)."""
        oob = (ids < -2) | (ids > self._max_id)
        return torch.where(oob, self._n_ids - 1, ids + 2)

    def _dense1(self, ids):
        rows = self._uni[self._id_row(ids)]
        return rows[..., 0], rows[..., 1], rows[..., 2] > 0.5

    def _dense2(self, a, b):
        rows = self._bi[self._id_row(a) * self._n_ids + self._id_row(b)]
        return rows[..., 0], rows[..., 1], rows[..., 2] > 0.5

    @classmethod
    def _fold_np(cls, ids):
        """The dual fold of a gram's ids (build time, Python ints)."""
        h1, h2 = cls._SEED1, cls._SEED2
        for t in ids:
            h1 = (h1 * cls._M1 + int(t) + 2) & _U32
            h2 = (h2 * cls._M2 + int(t) + 2) & _U32
        return h1, h2

    @classmethod
    def _fold1(cls, h1, h2, tok):
        """One fold step by token tensor `tok` (uint32 wraparound)."""
        t = (tok.long() + 2) & _U32
        return ((_mul32(h1, cls._M1) + t) & _U32,
                (_mul32(h2, cls._M2) + t) & _U32)

    @classmethod
    def _seed(cls, shape, device):
        return (torch.full(shape, cls._SEED1, dtype=torch.long,
                           device=device),
                torch.full(shape, cls._SEED2, dtype=torch.long,
                           device=device))

    def _lookup(self, k, h1, h2):
        """The hashed k-gram table: (logp, backoff, hit)."""
        hit, (lp, bo) = self._tables[k - 1].lookup(h1, h2)
        return lp, bo, hit

    def ctx_hashes(self, window):
        """window (..., order-1) ids, oldest first, -1 = empty.  The fold
        hashes [(h1, h2)] of the context suffixes of length 0..order-1:
        each is a context gram's key and the prefix of one more fold."""
        lead, n_ctx = window.shape[:-1], window.shape[-1]
        out = [self._seed(lead, window.device)]
        for j in range(1, n_ctx + 1):
            h1, h2 = self._seed(lead, window.device)
            for i in range(n_ctx - j, n_ctx):
                h1, h2 = self._fold1(h1, h2, window[..., i])
            out.append((h1, h2))
        return out

    def score(self, window, w):
        """log p(w | window) with full KenLM backoff: window (...,
        order-1) ids (oldest first, -1 empty), w ids broadcastable with
        window's leading shape.  Returns float32 of the broadcast shape."""
        window, w = window.long(), w.long()
        shape = torch.broadcast_shapes(window.shape[:-1], w.shape)
        if self._full is not None:  # one gather: the chain resolved
            n = self._n_ids
            if self.order == 1:
                return self._full[self._id_row(w)].expand(shape)
            idx = self._id_row(window[..., -(self.order - 1)])
            for i in range(-(self.order - 1) + 1, 0):
                idx = idx * n + self._id_row(window[..., i])
            return self._full[idx * n + self._id_row(w)].expand(shape)
        ctx = self.ctx_hashes(window)  # index = context length

        def gram(k, last):
            """(lp, bo, hit) of the k-gram ending in `last` (None: ending
            at the window's last slot, a context gram)."""
            if k == 1:
                return self._dense1(window[..., -1] if last is None
                                    else last)
            if k == 2 and self._bi is not None:
                a = window[..., -2] if last is None else window[..., -1]
                return self._dense2(a, window[..., -1] if last is None
                                    else last)
            if last is None:  # the window's last k ids
                return self._lookup(k, *ctx[k])
            return self._lookup(k, *self._fold1(*ctx[k - 1], last))

        acc = torch.zeros(shape, device=window.device)
        res = torch.zeros(shape, device=window.device)
        found = torch.zeros(shape, dtype=torch.bool, device=window.device)
        for k in range(self.order, 0, -1):
            lp, _, hit = gram(k, w)
            res = torch.where(~found & hit, lp + acc, res)
            found = found | hit
            if k > 1:
                # the (k-1)-length context's backoff (0 if unseen: ARPA)
                _, cbo, chit = gram(k - 1, None)
                acc = acc + torch.where(chit, cbo, 0.0)
        return torch.where(found, res, self.unk_logp + acc)

    def score_sequence(self, full, p):
        """log p(full[j] | full[:j]) for the last p positions of `full`
        ((..., n_hist + p) ids, oldest first, n_hist >= order-1): `score`
        at every position at once, each (order, end position) gram looked
        up once and shared between scoring and backoff context."""
        full = full.long()
        lead = full.shape[:-1]
        if p == 0:
            return torch.zeros(lead + (0,), device=full.device)
        if self._full is not None:  # one gather per position
            n = self._n_ids
            s0 = full.shape[-1] - p - (self.order - 1)
            idx = self._id_row(full[..., s0:s0 + p])
            for i in range(1, self.order):
                idx = idx * n + self._id_row(full[..., s0 + i:s0 + i + p])
            return self._full[idx]
        n_hist = full.shape[-1] - p
        grams = {}  # k -> (lp, bo, hit) at k-gram end offsets; p + 1 of
        #             them for k < order (the first ends at n_hist - 1,
        #             position 0's context), p for k == order
        for k in range(1, self.order + 1):
            length = p if k == self.order else p + 1
            e0 = n_hist if k == self.order else n_hist - 1
            if k == 1:
                grams[k] = self._dense1(full[..., e0:e0 + length])
                continue
            if k == 2 and self._bi is not None:
                grams[k] = self._dense2(full[..., e0 - 1:e0 - 1 + length],
                                        full[..., e0:e0 + length])
                continue
            h1, h2 = self._seed(lead + (length,), full.device)
            for i in range(k):
                s = e0 - k + 1 + i
                h1, h2 = self._fold1(h1, h2, full[..., s:s + length])
            grams[k] = self._lookup(k, h1, h2)
        shape = lead + (p,)
        acc = torch.zeros(shape, device=full.device)
        res = torch.zeros(shape, device=full.device)
        found = torch.zeros(shape, dtype=torch.bool, device=full.device)
        for k in range(self.order, 0, -1):
            lp, _, hit = grams[k]
            if k < self.order:
                lp, hit = lp[..., 1:], hit[..., 1:]
            res = torch.where(~found & hit, lp + acc, res)
            found = found | hit
            if k > 1:
                _, cbo, chit = grams[k - 1]
                acc = acc + torch.where(chit[..., :-1], cbo[..., :-1], 0.0)
        return torch.where(found, res, self.unk_logp + acc)


def _push(win, new):
    """Windows (..., n_ctx) with `new` (...) appended and the oldest slot
    dropped."""
    return torch.cat([win[..., 1:], new[..., None]], dim=-1)


def _window_after(full, n_valid, n_ctx):
    """Each row's last n_ctx ids of `full` (M, n_ctx + C) = its window
    followed by its n_valid emitted tokens."""
    idx = n_valid[:, None] + torch.arange(n_ctx, device=full.device)
    return full.gather(1, idx)


def _window_ext(state, ck):
    """Per candidate, the window after appending it: state (W, n_ctx),
    ck (K,) or (W, K) -> (W, K, n_ctx); and ck as (W, K)."""
    ck = ck.long()
    ck = ck.expand(state.shape[0], ck.shape[-1]) if ck.dim() == 1 else ck
    win = state[:, None, :].expand(*ck.shape, state.shape[1])
    return _push(win, ck), ck


class HashedNGramLM:
    """Token-level n-gram LM of any order with KenLM backoff semantics.

    State per hypothesis: the last order-1 token ids (W, max(order-1, 1)),
    -1 for empty slots and <s> (id V) in the newest at the start.  One
    gathered float per candidate on the dense full-table route, O(order)
    hashed lookups otherwise; `dense_full` as in `_HashedNGramTables`.
    Build from an ARPA file of any order with `from_arpa`, or from the
    parsed ngrams dict; `final` adds the </s> score (id V + 1) when
    `use_eos`.
    """

    def __init__(self, order, ngrams, vocab_size, unk_logp=None,
                 use_eos=True, dense_full=None, *, device=None):
        dev = resolve_device(device)
        self._t = _HashedNGramTables(order, ngrams, unk_logp, dense_full,
                                     dev)
        self.order = self._t.order
        self._v = int(vocab_size)
        self._bos = self._v  # parse_arpa_order's <s> id
        self._eos = self._v + 1
        self._use_eos = bool(use_eos)

    @property
    def device(self) -> torch.device:
        return self._t.device

    @classmethod
    def from_arpa(cls, path, vocab, **kw):
        from ..utils.arpa import parse_arpa_order

        order, ngrams = parse_arpa_order(path, list(vocab))
        return cls(order, ngrams, len(vocab), **kw)

    def init_state(self, w):
        win = torch.full((w, max(self.order - 1, 1)), -1, dtype=torch.long,
                         device=self.device)
        win[:, -1] = self._bos
        return win

    def score(self, state, ck):
        new_win, ck = _window_ext(state, ck)
        return self._t.score(state[:, None, :], ck), new_win

    def select(self, state, state_ext, parent, kk, is_stay):
        return torch.where(is_stay[:, None], state[parent],
                           state_ext[parent, kk])

    def final(self, state):
        if not self._use_eos:
            return torch.zeros(state.shape[0], device=state.device)
        return self._t.score(state, torch.full_like(state[:, 0], self._eos))

    def score_chunk(self, state, toks):
        """Every emitted token of the chunk scored against its order-1
        token history at once (`score_sequence`), vectorised over rows."""
        full = torch.cat([state, toks.long()], dim=1)
        valid = toks >= 0
        lp = self._t.score_sequence(full, toks.shape[1])
        return (torch.where(valid, lp, 0.0).sum(dim=1),
                _window_after(full, valid.sum(dim=1), state.shape[1]))


class HashedWordNGramLM(_WordBoundaryMode):
    """Word-level shallow fusion at any n-gram order, scored each time a
    word completes (at a boundary and at the end of the utterance), with
    KenLM backoff over the word history.  Boundaries: a separator token or
    BPE word starters (`boundary_ids`), as `WordNGramLM`.

    State per hypothesis: (word-history window (W, order-1), rolling spell
    hash of the word being typed, its length).  Completed words resolve to
    word ids through `_WordHash`; unknown words score <unk> plus the
    context's backoffs and enter the history as -2, an id that matches no
    stored gram.  Build from an ARPA word LM with `from_arpa`.
    """

    _MULT = 31
    _SEED = 5381

    def __init__(self, word_spellings, order, ngrams, space_id,
                 unk_logp=None, dense_full=None, boundary_ids=None, *,
                 device=None):
        dev = resolve_device(device)
        wv = len(word_spellings)
        self._wv = wv
        self._init_boundary(space_id, boundary_ids, dev)
        self._bos = wv  # parse_arpa_order's <s> id
        self._eos = wv + 1
        self._unk_word = -2  # history sentinel: matches no stored gram
        self._t = _HashedNGramTables(order, ngrams, unk_logp, dense_full,
                                     dev)
        self.order = self._t.order
        self._wh = _WordHash(word_spellings, self._unk_word, dev)

    @property
    def device(self) -> torch.device:
        return self._t.device

    @classmethod
    def from_arpa(cls, path, words, alphabet=None, space_symbol=" ",
                  spellings=None, boundary_ids=None, **kw):
        """words: word strings; alphabet: anything with `encode(str) ->
        token ids`.  For subword (BPE) models pass `spellings` (token-id
        tuples per word, each starting with its boundary token) and
        `boundary_ids` instead of an alphabet."""
        from ..utils.arpa import parse_arpa_order

        order, ngrams = parse_arpa_order(path, list(words))
        if spellings is None:
            spellings = [tuple(alphabet.encode(w)) for w in words]
        space_id = (None if boundary_ids is not None
                    else alphabet.encode(space_symbol)[0])
        return cls(spellings, order, ngrams, space_id,
                   boundary_ids=boundary_ids, **kw)

    def init_state(self, w):
        dev = self.device
        win = torch.full((w, max(self.order - 1, 1)), -1, dtype=torch.long,
                         device=dev)
        win[:, -1] = self._bos
        return (win,
                torch.full((w,), self._SEED, dtype=torch.long, device=dev),
                torch.zeros((w,), dtype=torch.long, device=dev))

    def score(self, state, ck):
        win, curh, curlen = state
        is_b = self._is_boundary(ck)
        is_b = is_b[None] if is_b.dim() == 1 else is_b  # (1, K) or (W, K)
        wid = self._wh.lookup(curh)  # the word a boundary would complete
        complete = torch.where(curlen > 0, self._t.score(win, wid), 0.0)
        lm_lp = torch.where(is_b, complete[:, None], 0.0)  # (W, K)
        win_b = win[:, None, :].expand(*lm_lp.shape, win.shape[1])
        ended = (is_b & (curlen > 0)[:, None])[..., None]
        new_win = torch.where(ended, _push(win_b, wid[:, None].expand(
            lm_lp.shape)), win_b)
        new_hash, new_len = self._advance_word_hash(is_b, curh, curlen, ck)
        return lm_lp, (new_win, new_hash, new_len)

    def select(self, state, state_ext, parent, kk, is_stay):
        return _where_rows(is_stay, tuple(s[parent] for s in state),
                           tuple(se[parent, kk] for se in state_ext))

    def final(self, state):
        """Complete the trailing word, then add the </s> score."""
        win, curh, curlen = state
        wid = self._wh.lookup(curh)
        typing = curlen > 0
        trailing = torch.where(typing, self._t.score(win, wid), 0.0)
        ended = torch.where(typing[:, None], _push(win, wid), win)
        return trailing + self._t.score(ended,
                                        torch.full_like(wid, self._eos))

    def score_chunk(self, state, toks):
        """Words completed inside the chunk are found with _chunk_words
        and scored in sequence order, one word column at a time up to the
        chunk's largest word count, vectorised over rows."""
        win, curh, curlen = state
        seg = self._segment_chunk(toks, curh, curlen)
        whash, n_words = seg["whash"], seg["n_words"]
        lp_sum = torch.zeros(toks.shape[0], device=toks.device)
        for j in range(int(n_words.max()) if toks.shape[0] else 0):
            live = j < n_words
            wid = self._wh.lookup(whash[:, j])
            lp_sum = lp_sum + torch.where(live, self._t.score(win, wid), 0.0)
            win = torch.where(live[:, None], _push(win, wid), win)
        return lp_sum, (win, seg["new_curh"], seg["new_curlen"])


class HotwordBoostLM:
    """Hotword / phrase boosting (pyctcdecode's `hotwords`): `weight` for
    every emitted token that continues some phrase (the emitted suffix
    matches one of its prefixes), plus `complete_bonus` each time a whole
    phrase completes.  It carries no probabilities: stack it on an LM with
    `CompositeLM`, or use it alone (lm_alpha scales it).

    State per hypothesis: the last max_len - 1 token ids, so a match is a
    function of the token window and a failed match re-enters a later
    phrase ("a b c d" matches "b c d" at 'd').  The prefix set is keyed by
    `_HashedNGramTables`' dual fold; distinct prefixes sharing (h1, h2)
    raise.  `phrases` are tuples of token ids.
    """

    def __init__(self, phrases, weight=1.0, complete_bonus=0.0, *,
                 device=None):
        dev = resolve_device(device)
        phrases = [tuple(int(t) for t in p) for p in phrases]
        if not phrases or any(len(p) == 0 for p in phrases):
            raise ValueError("phrases must be non-empty token sequences")
        if any(t < 0 for p in phrases for t in p):
            raise ValueError("phrase token ids must be non-negative")
        self._L = max(len(p) for p in phrases)
        complete = set(phrases)
        prefixes = {}
        for p in phrases:
            for n in range(1, len(p) + 1):
                pre = p[:n]
                prefixes[pre] = prefixes.get(pre, False) or (pre in complete)
        items = [(*_HashedNGramTables._fold_np(pre), (float(comp),))
                 for pre, comp in prefixes.items()]
        self._t = _SortedTable(items, 1, on_dup="error", device=dev)
        self._w = float(weight)
        self._cb = float(complete_bonus)
        self._dev = dev

    @property
    def device(self) -> torch.device:
        return self._dev

    def _boost(self, matched, complete):
        return self._w * matched.float() + self._cb * complete.float()

    def _bonus(self, window, w):
        """The boost for appending tokens w to windows (..., n_ctx)."""
        n_ctx = window.shape[-1]
        h = _HashedNGramTables
        shape = torch.broadcast_shapes(window.shape[:-1], w.shape)
        matched = torch.zeros(shape, dtype=torch.bool, device=w.device)
        complete = torch.zeros_like(matched)
        for n in range(1, self._L + 1):  # the suffix of length n ends in w
            h1, h2 = h._seed(window.shape[:-1], w.device)
            for i in range(n_ctx - (n - 1), n_ctx):
                h1, h2 = h._fold1(h1, h2, window[..., i])
            hit, (comp,) = self._t.lookup(*h._fold1(h1, h2, w))
            matched = matched | hit
            complete = complete | (hit & (comp > 0.5))
        return self._boost(matched, complete)

    def init_state(self, w):
        return torch.full((w, max(self._L - 1, 1)), -1, dtype=torch.long,
                          device=self.device)

    def score(self, state, ck):
        new_win, ck = _window_ext(state, ck)
        return self._bonus(state[:, None, :], ck), new_win

    def select(self, state, state_ext, parent, kk, is_stay):
        return torch.where(is_stay[:, None], state[parent],
                           state_ext[parent, kk])

    def final(self, state):
        return torch.zeros(state.shape[0], device=state.device)

    def score_chunk(self, state, toks):
        """Every position's boost at once from the sliding token window,
        with `score`'s suffix lookups, vectorised over rows."""
        n_ctx, p = state.shape[1], toks.shape[1]
        full = torch.cat([state, toks.long()], dim=1)
        valid = toks >= 0
        h = _HashedNGramTables
        matched = torch.zeros(valid.shape, dtype=torch.bool,
                              device=toks.device)
        complete = torch.zeros_like(matched)
        for n in range(1, self._L + 1):
            h1, h2 = h._seed(valid.shape, toks.device)
            for i in range(n):
                s = n_ctx - n + 1 + i
                h1, h2 = h._fold1(h1, h2, full[:, s:s + p])
            hit, (comp,) = self._t.lookup(h1, h2)
            matched = matched | hit
            complete = complete | (hit & (comp > 0.5))
        lp = self._boost(matched, complete)
        return (torch.where(valid, lp, 0.0).sum(dim=1),
                _window_after(full, valid.sum(dim=1), n_ctx))


class CompositeLM:
    """Weighted sum of protocol LMs sharing one decode (e.g. a word LM plus
    a `HotwordBoostLM`, pyctcdecode's hotwords setup).  The state is the
    tuple of the members' states, so every decode path takes it; lm_alpha
    and lm_beta apply on top of the member `weights`.  The members' tables
    must share a device."""

    def __init__(self, lms, weights=None):
        self._lms = tuple(lms)
        if not self._lms:
            raise ValueError("CompositeLM needs at least one member LM")
        self._w = tuple(float(x) for x in (
            weights if weights is not None else (1.0,) * len(self._lms)))
        if len(self._w) != len(self._lms):
            raise ValueError("weights must match the number of LMs")
        if len({lm.device for lm in self._lms}) != 1:
            raise ValueError("CompositeLM's members must share a device")

    @property
    def device(self) -> torch.device:
        return self._lms[0].device

    def init_state(self, w):
        return tuple(lm.init_state(w) for lm in self._lms)

    def _sum(self, parts):
        tot = None
        for wt, x in zip(self._w, parts):
            tot = wt * x if tot is None else tot + wt * x
        return tot

    def score(self, state, ck):
        out = [lm.score(st, ck) for lm, st in zip(self._lms, state)]
        return self._sum(lp for lp, _ in out), tuple(e for _, e in out)

    def select(self, state, state_ext, parent, kk, is_stay):
        return tuple(lm.select(st, ext, parent, kk, is_stay)
                     for lm, st, ext in zip(self._lms, state, state_ext))

    def final(self, state):
        return self._sum(lm.final(st) for lm, st in zip(self._lms, state))

    def score_chunk(self, state, toks):
        out = [lm.score_chunk(st, toks) for lm, st in zip(self._lms, state)]
        return self._sum(lp for lp, _ in out), tuple(s for _, s in out)
