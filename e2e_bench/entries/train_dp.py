"""Timed entry: `train`'s CTC step, data parallel over `mix["ranks"]` GPUs.

Rank 0 is the harness's process, on the harness's device.  It builds the
port's kernel library, then starts ranks 1 .. D-1 as processes of their
own (`python -m e2e_bench.entries.train_dp <json>`, rank r on cuda:r, its
output on rank 0's standard error), and all join one NCCL group (gloo on
the CPU) over TCP on localhost, with a 120 s timeout.  At global step g
rank r trains on batch D g + r of the mix's schedule: its rows' log-probs
through the port's `ctc_loss_data_parallel` (the whole step's mean,
replicated), `backward()`, the port's `sum_gradients` (every rank then
holds the whole step's gradient) and AdamW alike on every rank.  Rank 0
broadcasts each window step's go (1), and a stop (0) at the end; the
other ranks follow; every rank then destroys the group at once (NCCL's
teardown waits on its ring neighbours) and rank 0 checks the others' exit
codes.  A
step's work is all D batches': their audio and model operations.

The check: rank 0's readings of the checked steps (`train`'s) against the
reference, which runs each checked step's D batches in turn on rank 0's
card as one mean loss (each batch's mean weighted by its rows), with its
own AdamW; and `rank_mismatch`, the number of parameter elements of any
rank that differ from rank 0's, bit for bit, after the checked steps.
A commit without `sum_gradients` fails at import, before any process
starts.
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import subprocess
import sys
import time
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist
from torch.profiler import record_function

from e2e_bench import compare, flops, harness, programs, traffic, weights
from e2e_bench.entries.train import Entry as TrainEntry
from e2e_bench.reference import adamw
from e2e_bench.reference.conformer import Precision, card_precision
from end2end_tpu_torch.parallel.sharding import (ctc_loss_data_parallel,
                                                 sum_gradients)
from end2end_tpu_torch.utils import cuda_build

KIND = "train"
ROOT = Path(__file__).resolve().parents[2]
TIMEOUT = timedelta(seconds=120)
JOIN_S = 60


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Entry(TrainEntry):
    def __init__(self, cfg: dict, mix: dict, seed: int, device,
                 rank: int = 0, port: int | None = None):
        super().__init__(cfg, mix, seed, device)
        self.ranks, self.rank, self.port = mix["ranks"], rank, port
        self.procs = []

    def _batch(self, g: int, r: int | None = None) -> int:
        """The batch set's index of rank r's batch (this rank's when
        None) at global step g."""
        return self.batch_index(self.ranks * g
                                + (self.rank if r is None else r))

    def work(self, g: int) -> dict:
        cfg, audio, ops = self.cfg, 0.0, 0.0
        for r in range(self.ranks):
            b = self.set[self._batch(g, r)]
            audio += b.audio_s(cfg["sample_rate"])
            ops += 3 * sum(flops.forward(s, p, cfg)
                           for s, p in zip(b.samples, b.targets))
        return {"audio_s": audio, "flops": ops, "bounds": {}}

    # -- the group -------------------------------------------------------------
    def _spawn(self, warm: bool):
        for r in range(1, self.ranks):
            arg = {"cfg": self.cfg, "mix": self.mix, "seed": self.seed,
                   "rank": r, "port": self.port, "warm": warm,
                   "device": (f"cuda:{r}" if self.dev.type == "cuda"
                              else "cpu")}
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "e2e_bench.entries.train_dp",
                 json.dumps(arg)], cwd=ROOT, stdout=sys.stderr))
        atexit.register(self._kill)

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()

    def _join(self):
        rcs, deadline = [], time.monotonic() + JOIN_S
        for p in self.procs:
            try:
                rcs.append(p.wait(max(0.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append("timeout")
        if any(rc != 0 for rc in rcs):
            raise RuntimeError(f"ranks 1-{self.ranks - 1} exited with {rcs}")

    def _flag(self, go: int) -> bool:
        """Rank 0's go (1) or stop (0), broadcast; True to go on."""
        flag = torch.full((1,), go, dtype=torch.int32, device=self.dev)
        dist.broadcast(flag, 0)
        return bool(flag.item()) if self.rank else bool(go)

    # -- set-up ----------------------------------------------------------------
    def setup(self, warm: bool = True):
        cfg, dev = self.cfg, self.dev
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if self.rank == 0:
            if dev.type == "cuda":
                cuda_build.library()  # built once, before the ranks load it
            self.port = _free_port()
            self._spawn(warm)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"tcp://127.0.0.1:{self.port}",
            world_size=self.ranks, rank=self.rank, timeout=TIMEOUT)
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
            self._loss(*self.inputs[j]).backward()
            sum_gradients(self.model)
        self.opt.zero_grad(set_to_none=True)
        names = dict((p, k) for k, p in self.model.named_parameters())
        losses = []
        for g in range(self.n_check):
            losses.append(self._step(g))
            if g == 0:
                beta1 = o["betas"][0]
                grads = {names[p]: float(s["exp_avg"].norm()) / (1 - beta1)
                         for p, s in self.opt.state.items()}
        changes = {k: float((p.detach() - w0[k]).norm())
                   for k, p in self.model.named_parameters()}
        self.readings = {"losses": [float(x) for x in losses],
                         "grads": {k: grads.get(k, 0.0) for k in changes},
                         "changes": changes}
        del w0
        self.mismatch = self._mismatch()

    def _mismatch(self) -> int:
        """Parameter elements of any rank whose bits differ from rank
        0's."""
        mine = torch.cat([p.detach().reshape(-1)
                          for p in self.model.parameters()])
        theirs = mine.clone()
        dist.broadcast(theirs, 0)
        bad = (mine.view(torch.int32) != theirs.view(torch.int32)).sum()
        bad = bad.reshape(1).to(torch.int64)
        dist.all_reduce(bad)
        return int(bad.item())

    def _loss(self, wave, n, tgt, tl):
        logits, out_len = self.model.encode(wave, n)
        lp = torch.log_softmax(logits, dim=-1).transpose(0, 1)
        return ctc_loss_data_parallel(lp, tgt, out_len, tl,
                                      zero_infinity=True)

    def _step(self, g: int):
        batch = self.inputs[self._batch(g)]
        with record_function("train.forward"):
            loss = self._loss(*batch)
        with record_function("train.backward"):
            loss.backward()
            sum_gradients(self.model)
        with record_function("train.optimizer"):
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
        return loss.detach()

    # -- the window --------------------------------------------------------------
    def step(self, k: int) -> dict:
        self._flag(1)
        g = self.n_check + k
        out = self.work(g)
        out["loss"] = self._step(g)
        return out

    def follow(self):
        """Ranks 1 .. D-1: steps while rank 0 says go."""
        k = 0
        while self._flag(0):
            self._step(self.n_check + k)
            k += 1

    def free(self):
        """Stop and join the other ranks; drop the port's state and keep
        the checked steps' inputs."""
        if self.rank == 0:
            self._flag(0)
        dist.destroy_process_group()  # every rank, before rank 0 joins
        if self.rank == 0:
            self._join()
        keep = {self._batch(g, r) for g in range(self.n_check)
                for r in range(self.ranks)}
        self.inputs = [x if j in keep else None
                       for j, x in enumerate(self.inputs)]
        del self.model, self.opt
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------------
    def reference_readings(self, prec: Precision, half: bool = False,
                           drop: int | None = None):
        """The reference's readings of the checked steps: each step's D
        batches in turn as one mean loss (`half`: each batch's first half
        only; `drop`: that rank's batch counted in the loss but left out
        of the gradient, the fault of a sum that misses a rank)."""
        o = self.mix["optimizer"]
        params = {k: v.requires_grad_()
                  for k, v in weights.draw(self.spec, self.w_seed,
                                           self.dev).items()}
        opt = adamw.AdamW(params, o["lr"], tuple(o["betas"]), o["eps"],
                          o["weight_decay"])
        losses, grads = [], {}
        with card_precision(prec):
            for g in range(self.n_check):
                batches = [self.inputs[self._batch(g, r)]
                           for r in range(self.ranks)]
                if half:
                    batches = [[x[: max(1, len(x) // 2)] for x in b]
                               for b in batches]
                rows = sum(len(b[0]) for b in batches)
                total = 0.0
                for r, b in enumerate(batches):
                    part = self.ref.loss(params, self.cfg, *b, prec) * (
                        len(b[0]) / rows)
                    if r != drop:
                        part.backward()
                    total += float(part.detach())
                losses.append(total)
                if g == 0:
                    grads = {name: (0.0 if p.grad is None
                                    else float(p.grad.norm()))
                             for name, p in params.items()}
                opt.step()
        w0 = weights.draw(self.spec, self.w_seed, self.dev)
        changes = {k: float((p.detach() - w0[k]).norm())
                   for k, p in params.items()}
        return {"losses": losses, "grads": grads, "changes": changes}

    def check(self) -> dict:
        out = compare.train_numbers(self.readings,
                                    self.reference_readings(Precision(False)))
        out["rank_mismatch"] = float(self.mismatch)
        return out


def main(argv) -> None:
    """Rank r of the group: set-up, then the steps rank 0 calls for."""
    a = json.loads(argv[0])
    harness.apply_precision(a["cfg"])
    e = Entry(a["cfg"], a["mix"], a["seed"], a["device"], a["rank"],
              a["port"])
    e.setup(a["warm"])
    e.follow()
    e.free()
    sys.stdout.flush()
    os._exit(0)  # no interpreter teardown after the group's


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
