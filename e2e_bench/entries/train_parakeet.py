"""Timed entry: one training step of Parakeet-RNNT 1.1B (the FastConformer
transducer) through the port's `ConformerTransducer.loss`, timed, traced
and checked as `train` does the other transducer.  What differs is keyed
here: the model's build (the port's FastConformer, LSTM and ReLU options,
imported from the port as `programs.build` imports the others), the
reference (`reference.parakeet`), the weights (NeMo's forget-gate bias of
1.0 on the seeded draw), frames at 8x and the model operations
(`flops_fastconformer`); K8/K9's bounds at the 8x lattices.  A port
without the options fails when the entry is made, before any weight is
drawn.
"""

from __future__ import annotations

import torch

from e2e_bench import (bounds, flops_fastconformer, programs, traffic,
                       weights)
from e2e_bench.entries.train import Entry as TrainEntry
from e2e_bench.reference import adamw, fastconformer, parakeet
from e2e_bench.reference.conformer import Precision, card_precision
from end2end_tpu_torch.models.transducer import (ConformerTransducer,
                                                 TransducerConfig)

KIND = "train"


def model_config(cfg: dict) -> TransducerConfig:
    """The port's configuration of the model."""
    return TransducerConfig(
        vocab_size=cfg["vocab_size"], n_mels=cfg["n_mels"],
        d_model=cfg["d_model"], num_layers=cfg["num_layers"],
        num_heads=cfg["num_heads"], conv_kernel=cfg["conv_kernel_size"],
        enc_dim=cfg["enc_dim"], emb_dim=cfg["pred_emb_dim"],
        pred_hidden=cfg["pred_hidden"], joint_dim=cfg["joint_hidden"],
        subsampling=cfg["subsampling"],
        subsampling_factor=cfg["subsampling_factor"],
        subsampling_conv_channels=cfg["subsampling_conv_channels"],
        self_attention=cfg["self_attention"], xscaling=cfg["xscaling"],
        conv_norm=cfg["conv_norm"], predictor=cfg["predictor"],
        pred_layers=cfg["pred_rnn_layers"],
        joint_activation=cfg["joint_activation"])


class Entry(TrainEntry):
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        super().__init__(cfg, mix, seed, device)
        self.ref = parakeet
        self.spec = parakeet.spec(cfg)
        self.config = model_config(cfg)

    def work(self, j: int) -> dict:
        b, cfg = self.set[j], self.cfg
        t_max = flops_fastconformer.frames(b.pad_samples, cfg)[-1]
        n, up = len(b.rows), b.pad_targets + 1
        return {"audio_s": b.audio_s(cfg["sample_rate"]),
                "flops": 3 * sum(flops_fastconformer.forward(s, p, cfg)
                                 for s, p in zip(b.samples, b.targets)),
                "bounds": {"rnnt_loss": bounds.rnnt_bound(n, t_max, up, False)
                           + bounds.rnnt_bound(n, t_max, up, True)}}

    def draw(self) -> dict:
        """The seed's weights, as loaded into the port and the reference."""
        return parakeet.init_forget_bias(
            weights.draw(self.spec, self.w_seed, self.dev), self.cfg)

    # -- set-up (as `train`'s, with this model's build and draw) ---------------
    def setup(self, warm: bool = True):
        cfg, dev = self.cfg, self.dev
        w0 = self.draw()
        self.model = ConformerTransducer(self.config, device=dev)
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

    # -- the check ------------------------------------------------------------------
    def reference_readings(self, prec: Precision, half: bool = False):
        """As `train`'s, on this model's draw; BatchNorm's running
        statistics are not trained and not read in training mode."""
        o = self.mix["optimizer"]
        params = {k: v.requires_grad_() for k, v in self.draw().items()
                  if not fastconformer.is_buffer(k)}
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
        w0 = self.draw()
        changes = {k: float((p.detach() - w0[k]).norm())
                   for k, p in params.items()}
        return {"losses": losses, "grads": grads, "changes": changes}
