"""Timed entry: one training step of the port's model.

A step is the port's `loss` on a batch, `backward()`, and one
`torch.optim.AdamW` step at a fixed learning rate, with no host read in
between.  Set-up draws the weights and the batch set, runs a forward and
backward once at every batch shape (no update), and then the first
`check.steps` steps through the same call as the window, recording what
the check compares: each step's loss, each leaf's first gradient norm
(from AdamW's first moment after one step) and each leaf's change after
the last of them.  The window then carries on from that state.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from e2e_bench import bounds, compare, flops, programs, traffic, weights
from e2e_bench.reference import adamw
from e2e_bench.reference import ctc as ref_ctc
from e2e_bench.reference import transducer as ref_transducer
from e2e_bench.reference.conformer import Precision, card_precision

KIND = "train"
REFERENCES = {"ctc": ref_ctc, "transducer": ref_transducer}


class Entry:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.dev = torch.device(device)
        self.ref = REFERENCES[cfg["model"]]
        self.spec = self.ref.spec(cfg)
        self.set = traffic.batches(mix, cfg)
        self.w_seed, self.in_seed, _ = traffic.seeds(seed, 3)
        self.n_check = mix["check"]["steps"]
        self.batch_index = traffic.Schedule(mix, len(self.set)).index

    def work(self, j: int) -> dict:
        b, cfg = self.set[j], self.cfg
        il = [flops.frames(n, cfg)[2] for n in b.samples]
        t_max = flops.frames(b.pad_samples, cfg)[2]
        n = len(b.rows)
        if cfg["model"] == "ctc":
            s, tl = b.pad_targets, list(b.targets)
            group = ("ctc_loss",
                     bounds.ctc_bound(t_max, n, s, il, tl, False)
                     + bounds.ctc_bound(t_max, n, s, il, tl, True)
                     + bounds.ctc_grad_bound(t_max, n, cfg["vocab_size"], s,
                                             il, tl))
        else:
            up = b.pad_targets + 1
            group = ("rnnt_loss", bounds.rnnt_bound(n, t_max, up, False)
                     + bounds.rnnt_bound(n, t_max, up, True))
        return {"audio_s": b.audio_s(cfg["sample_rate"]),
                "flops": 3 * sum(flops.forward(s, p, cfg)
                                 for s, p in zip(b.samples, b.targets)),
                "bounds": dict([group])}

    # -- set-up ----------------------------------------------------------------
    def setup(self, warm: bool = True):
        cfg, dev = self.cfg, self.dev
        w0 = weights.draw(self.spec, self.w_seed, dev)
        self.model = programs.build(cfg, dev)
        weights.check_layout(self.model.state_dict(), self.spec)
        self.model.load_state_dict(w0)
        self.model.train()
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.in_seed)
        self.inputs = [traffic.materialise(b, cfg, gen, dev)
                       for b in self.set]
        o = self.mix["optimizer"]
        self.opt = torch.optim.AdamW(
            self.model.parameters(), lr=o["lr"], betas=tuple(o["betas"]),
            eps=o["eps"], weight_decay=o["weight_decay"])
        shapes = {}
        for j, b in enumerate(self.set):
            shapes.setdefault((len(b.rows), b.pad_samples, b.pad_targets), j)
        for j in shapes.values() if warm else ():
            programs.loss(self.model, cfg, *self.inputs[j]).backward()
        self.opt.zero_grad(set_to_none=True)
        names = dict((p, k) for k, p in self.model.named_parameters())
        losses = []
        for k in range(self.n_check):
            losses.append(self._step(k))
            if k == 0:
                beta1 = o["betas"][0]
                grads = {names[p]: float(s["exp_avg"].norm()) / (1 - beta1)
                         for p, s in self.opt.state.items()}
        changes = {k: float((p.detach() - w0[k]).norm())
                   for k, p in self.model.named_parameters()}
        self.readings = {"losses": [float(x) for x in losses],
                         "grads": {k: grads.get(k, 0.0) for k in changes},
                         "changes": changes}
        del w0

    def _step(self, k: int):
        wave, n, tgt, tl = self.inputs[self.batch_index(k)]
        with record_function("train.forward"):
            loss = programs.loss(self.model, self.cfg, wave, n, tgt, tl)
        with record_function("train.backward"):
            loss.backward()
        with record_function("train.optimizer"):
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
        return loss.detach()

    # -- the window --------------------------------------------------------------
    def step(self, k: int) -> dict:
        j = self.batch_index(self.n_check + k)
        out = self.work(j)
        out["loss"] = self._step(self.n_check + k)
        return out

    @staticmethod
    def failures(works) -> int:
        if not works:
            return 0
        return int((~torch.isfinite(torch.stack([w["loss"] for w in works])))
                   .sum())

    def free(self):
        """Drop the port's state; keep the checked steps' inputs."""
        keep = {self.batch_index(k) for k in range(self.n_check)}
        self.inputs = [x if j in keep else None
                       for j, x in enumerate(self.inputs)]
        del self.model, self.opt
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------------
    def reference_readings(self, prec: Precision, half: bool = False):
        """The reference's readings of the checked steps (`half`: each
        batch's first half only, the fault of a step that leaves half of
        the batch out)."""
        o = self.mix["optimizer"]
        params = {k: v.requires_grad_()
                  for k, v in weights.draw(self.spec, self.w_seed,
                                           self.dev).items()}
        opt = adamw.AdamW(params, o["lr"], tuple(o["betas"]), o["eps"],
                          o["weight_decay"])
        losses, grads = [], {}
        with card_precision(prec):
            for k in range(self.n_check):
                batch = self.inputs[self.batch_index(k)]
                if half:
                    batch = [x[: max(1, len(x) // 2)] for x in batch]
                loss = self.ref.loss(params, self.cfg, *batch, prec)
                loss.backward()
                losses.append(float(loss.detach()))
                if k == 0:
                    grads = {name: (0.0 if p.grad is None
                                    else float(p.grad.norm()))
                             for name, p in params.items()}
                opt.step()
        w0 = weights.draw(self.spec, self.w_seed, self.dev)
        changes = {k: float((p.detach() - w0[k]).norm())
                   for k, p in params.items()}
        return {"losses": losses, "grads": grads, "changes": changes}

    def check(self) -> dict:
        ref = self.reference_readings(Precision(False))
        return compare.train_numbers(self.readings, ref)
