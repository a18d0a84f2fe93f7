"""Timed entry: one closed-loop decode batch of the port's CTC pipeline.

A step submits a batch to `decode` (greedy, or prefix beam search with
the mix's beam width and prune) and waits until its tokens, lengths and
scores are on the host; each request's latency runs from the submission
to that moment.  Set-up draws the weights (shaped as the mix says) and
every batch's audio on the device, and decodes once at each padded
length.  The check runs a seeded sample of the finished requests, the
longest among them and every row of a batch, through the reference, each
request alone but padded as its batch was (the port's convolution module lets the padding reach a
clip's last frames once its first Linear has a bias).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from e2e_bench import bounds, compare, flops, programs, traffic, weights
from e2e_bench.reference import ctc as ref_ctc
from e2e_bench.reference.conformer import Precision, card_precision

KIND = "decode"


class Entry:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        if cfg["model"] != "ctc":
            raise ValueError("the decode entry serves CTC models")
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.dev = torch.device(device)
        self.spec = ref_ctc.spec(cfg)
        self.set = traffic.batches(mix, cfg)
        self.w_seed, self.in_seed, self.pick_seed = traffic.seeds(seed, 3)
        d = mix["decode"]
        self.beam, self.prune = d["beam_width"], d.get("prune_k")
        self.batch_index = traffic.Schedule(mix, len(self.set)).index
        self.served = []  # (batch index, tokens, lengths, scores) on the host

    def setup(self, warm: bool = True):
        cfg, dev = self.cfg, self.dev
        w = weights.draw(self.spec, self.w_seed, dev,
                         self.mix["weights"])
        self.model = programs.build(cfg, dev)
        weights.check_layout(self.model.state_dict(), self.spec)
        self.model.load_state_dict(w)
        self.model.eval()
        del w
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.in_seed)
        self.inputs = [traffic.materialise(b, cfg, gen, dev)[:2]
                       for b in self.set]
        lengths = {}
        for j, b in enumerate(self.set):
            lengths.setdefault(b.pad_samples, j)
        for j in lengths.values() if warm else ():
            programs.decode(self.model, *self.inputs[j], self.beam,
                            self.prune)[0].cpu()

    def step(self, k: int) -> dict:
        j = self.batch_index(k)
        wave, n = self.inputs[j]
        t0 = time.perf_counter()
        with record_function("decode.model"):
            out = programs.decode(self.model, wave, n, self.beam, self.prune)
        with record_function("decode.result"):
            tokens, lengths, scores = (x.cpu() for x in out)
        latency = time.perf_counter() - t0
        self.served.append((j, tokens.numpy(), lengths.numpy(),
                            scores.numpy()))
        b, cfg = self.set[j], self.cfg
        work = {"audio_s": b.audio_s(cfg["sample_rate"]),
                "flops": sum(flops.forward(s, 0, cfg) for s in b.samples),
                "latencies_s": [latency] * len(b.rows),
                "tokens": int(lengths.sum()),
                "failed": int((~np.isfinite(scores.numpy())).sum()),
                "bounds": {}}
        if self.beam:
            t_max = flops.frames(b.pad_samples, cfg)[2]
            il = [flops.frames(s, cfg)[2] for s in b.samples]
            v, n_rows = cfg["vocab_size"], len(b.rows)
            k_prune = min(self.prune or v, v)
            ks = min(k_prune + 8, v)
            work["bounds"]["beam"] = (
                bounds.topk_bound(t_max * n_rows, v, ks)
                + bounds.beam_bound(t_max, n_rows, ks, il, self.beam, k_prune)
                + bounds.backtrace_bound(t_max, self.beam, n_rows,
                                         min(t_max, 512),
                                         int(lengths.sum())))
        return work

    @staticmethod
    def failures(works) -> int:
        return sum(w["failed"] for w in works)

    def free(self):
        del self.model
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------
    def sample(self) -> list:
        """(served index, row) of the checked requests: the longest finished
        one, and for each row of a batch `check.requests` / `batch` others
        in that row, from served batches drawn from the seed, so that a
        fault confined to one row of the batch is in the sample."""
        size = lambda q: self.set[self.served[q[0]][0]].samples[q[1]]
        rows = self.mix["batch"]
        longest = max(((i, r) for i in range(len(self.served))
                       for r in range(rows)), key=size)
        rng = np.random.default_rng(self.pick_seed)
        per = max(1, self.mix["check"]["requests"] // rows)
        picks = [longest]
        for r in range(rows):
            others = [i for i in range(len(self.served))
                      if (i, r) != longest]
            picks += [(int(i), r) for i in
                      rng.choice(others, min(per, len(others)), replace=False)]
        return picks

    def served_outputs(self, picks) -> list:
        """[(tokens, score)] the port served for the picked requests."""
        out = []
        for i, r in picks:
            _, tokens, lengths, scores = self.served[i]
            out.append((tokens[r, : lengths[r]].tolist(), float(scores[r])))
        return out

    def reference_log_probs(self, picks, prec: Precision) -> list:
        """The reference's (T', V) float64 log-probs of each picked request,
        run alone, padded as in its batch."""
        w = weights.draw(self.spec, self.w_seed, self.dev,
                         self.mix["weights"])
        out = []
        with torch.no_grad(), card_precision(prec):
            for i, r in picks:
                wave, n = self.inputs[self.served[i][0]]
                lp, t = ref_ctc.log_probs(w, self.cfg, wave[r: r + 1],
                                          n[r: r + 1], prec)
                out.append(lp[0, : int(t[0])].double().cpu().numpy())
        return out

    def s_caps(self, picks) -> list:
        """Each picked request's symbol cap: the decoder's default,
        min(T', 512) of its padded batch."""
        return [min(flops.frames(self.set[self.served[i][0]].pad_samples,
                                 self.cfg)[2], 512) for i, _ in picks]

    def check(self) -> dict:
        picks = self.sample()
        served = self.served_outputs(picks)
        self.check_notes = {"checked_requests": len(picks),
                            "checked_tokens": sum(len(t) for t, _ in served)}
        return compare.serve_numbers(
            served,
            self.reference_log_probs(picks, Precision(False)),
            self.mix["decode"] if self.beam else None, self.cfg["blank"],
            self.s_caps(picks), self.check_notes)
