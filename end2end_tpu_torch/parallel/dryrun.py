"""A multi-GPU dry run: every parallel path of the port at tiny sizes over a
group of spawned processes (the torch counterpart of the JAX package's
`dryrun_multichip`).

    python -m end2end_tpu_torch.parallel.dryrun 4             # on the card
    python -m end2end_tpu_torch.parallel.dryrun 4 --device cpu

`dryrun_multichip(n_ranks)` spawns n_ranks gloo ranks (a `file://`
rendezvous in a fresh temporary directory), on the card unless
device="cpu" is asked for (rank r on CUDA device r modulo the count: one
card takes every rank, gloo staging CUDA tensors through the host), and
runs on each, asserting as it goes:
  * a data-parallel train step of a tiny Conformer-CTC pipeline (vocab
    16, d 64, 2 layers, 16 mels): each rank's loss on its rows, the
    gradients averaged by one all-reduce, one AdamW step;
  * the vocabulary-sharded CTC loss, the greedy and beam decoders and the
    chunked word-LM route (V = 4 n_ranks);
  * both vocabulary-sharded fused transducer losses, two descending
    steps each, the kernel path within 5e-2 of the float32 one;
  * the data-parallel transducer greedy, ALSD beam and streaming decodes
    (the streaming one equal to the beam one);
  * the time-sharded CTC loss (T = 8 n_ranks).
Every rank reports whether it imported JAX, flax or the JAX package
(never); a rank that fails
makes the run raise.  One summary line is printed.

JAX's dry run also shards the pipeline's weights over a 'model' axis of
its mesh: a layout GSPMD chooses, which changes no number.  The port's
tensor parallelism is the vocabulary-sharded losses and decoders above,
which run over the whole group.
"""

from __future__ import annotations

import argparse
import datetime
import sys
import tempfile
from functools import partial

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..utils.device import resolve_device

TIMEOUT = datetime.timedelta(seconds=300)  # a stuck collective raises


def jax_free() -> bool:
    """True when this process has imported none of JAX, flax or the JAX
    package."""
    return not any(m.split(".")[0] in ("jax", "flax", "end2end_tpu")
                   for m in sys.modules)


def _rank_device(device: str, rank: int) -> torch.device:
    if device == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device(device)


def _dp_train_step(rank, d, dev):
    """The tiny pipeline's data-parallel AdamW step: (loss on the rank's
    rows, the largest difference of the stepped parameters across
    ranks)."""
    from ..models.pipeline import ConformerCTCPipeline, PipelineConfig

    cfg = PipelineConfig(vocab_size=16, d_model=64, num_layers=2,
                         num_heads=2, n_mels=16)
    pipe = ConformerCTCPipeline(cfg, device=dev,
                                generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    b = 2 * d
    wav = rng.standard_normal((b, 4000)).astype(np.float32)
    ns = np.full((b,), 4000, np.int32)
    tgt = rng.integers(1, 16, (b, 3)).astype(np.int32)
    tl = np.full((b,), 3, np.int32)
    rows = slice(rank * 2, rank * 2 + 2)
    opt = torch.optim.AdamW(pipe.parameters(), lr=1e-3)
    loss = pipe.loss(wav[rows], ns[rows], tgt[rows], tl[rows])
    loss.backward()
    params = [p for p in pipe.parameters() if p.grad is not None]
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat)  # one all-reduce: the batch-mean gradient
    flat /= d
    off = 0
    for p in params:
        p.grad.copy_(flat[off:off + p.numel()].view_as(p))
        off += p.numel()
    opt.step()
    loss = loss.item()
    assert np.isfinite(loss) and loss > 0.0, f"bad loss {loss}"
    w = torch.cat([p.detach().reshape(-1) for p in pipe.parameters()])
    spread = w.clone()
    dist.all_reduce(spread, op=dist.ReduceOp.MAX)
    return loss, float((spread - w).abs().max())


def _vocab_parallel(rng, d, dev):
    from ..ops.lm import WordNGramLM
    from .vocab_parallel import (beam_search_decode_vocab_parallel,
                                 ctc_nll_vocab_parallel,
                                 greedy_decode_vocab_parallel)

    t, b, v = 16, 2, 4 * d
    lp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((t, b, v)).astype(np.float32)), -1).to(dev)
    il = np.full(b, t, np.int32)
    tgt = rng.integers(1, v, (b, 4)).astype(np.int32)
    tl = np.full(b, 4, np.int32)
    nll = ctc_nll_vocab_parallel(lp, tgt, il, tl)
    greedy_decode_vocab_parallel(lp, il)
    _, _, b_scores = beam_search_decode_vocab_parallel(
        lp, il, beam_width=4, max_symbols=8)
    assert torch.isfinite(nll).all() and torch.isfinite(b_scores[:, 0]).all()
    words = [(1,), (2,), (1, 2)]
    wv = len(words)
    w_lm = WordNGramLM(
        words,
        np.log(np.maximum(rng.random((wv, wv)).astype(np.float32), 1e-3)),
        rng.standard_normal(wv).astype(np.float32), space_id=3,
        unigram_logp=rng.standard_normal(wv).astype(np.float32),
        unk_logp=-13.0, device=dev)
    _, _, c_scores = beam_search_decode_vocab_parallel(
        lp, il, beam_width=4, max_symbols=8, lm=w_lm, lm_alpha=0.5,
        lm_beta=0.2, implementation="chunked", lm_chunk_t=8)
    assert torch.isfinite(c_scores[:, 0]).all()
    return tgt, tl, float(nll[0]), float(c_scores[0, 0])


def _fused_tp_steps(rng, d, dev):
    """Two descending steps of each vocabulary-sharded fused transducer
    loss: ((f32 loss 1, loss 2), (kernel path loss 1, loss 2))."""
    from .vocab_parallel import (rnnt_nll_fused_pallas_vocab_parallel,
                                 rnnt_nll_fused_vocab_parallel)

    b, v, jdim, t_r, u_r = 2, 4 * d, 8, 10, 3

    def f32(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    enc = f32(rng.standard_normal((b, t_r, jdim)))
    pred = f32(rng.standard_normal((b, u_r + 1, jdim)))
    w_out = f32(rng.standard_normal((jdim, v)) / np.sqrt(jdim))
    b_out = torch.zeros(v, device=dev)
    tgt = rng.integers(1, v, (b, u_r)).astype(np.int32)
    il, ul = np.full(b, t_r, np.int32), np.full(b, u_r, np.int32)
    out = []
    for loss_fn in (partial(rnnt_nll_fused_vocab_parallel, chunk_t=4),
                    rnnt_nll_fused_pallas_vocab_parallel):
        e, w = enc.clone().requires_grad_(), w_out.clone().requires_grad_()
        losses = []
        for _ in range(2):
            loss = loss_fn(e, pred, w, b_out, tgt, il, ul).mean()
            ge, gw = torch.autograd.grad(loss, (e, w))
            # each rank holds its columns of w's gradient: their sum is
            # the whole gradient, the step every rank takes
            dist.all_reduce(gw)
            with torch.no_grad():
                e -= 1e-2 * ge
                w -= 1e-2 * gw
            losses.append(loss.item())
        assert all(np.isfinite(losses)) and losses[1] < losses[0], losses
        out.append(tuple(losses))
    assert abs(out[1][0] - out[0][0]) < 5e-2, out
    return out


def _dp_transducer(rng, rank, d, dev):
    """The data-parallel transducer greedy, beam and streaming decodes on
    this rank's rows: (greedy score, beam score) of its first row."""
    from ..ops.neural_lm import gru_step, random_gru_params
    from ..ops.rnnt_decode import FactoredAdditiveJoint
    from ..ops.streaming_decode import StreamingRNNTBeamDecoder
    from .sharding import (DataParallelStreamingRNNT,
                           rnnt_beam_decode_data_parallel,
                           rnnt_greedy_decode_data_parallel)

    nd, td, vd, hd = 2 * d, 12, 9, 8
    enc = torch.from_numpy(rng.standard_normal((nd, td, hd))
                           .astype(np.float32)).to(dev)
    gp = {k: torch.from_numpy(x).to(dev) for k, x in random_gru_params(
        rng, vd, emb_dim=4, hidden_dim=hd).items()}

    def wj(*s):
        return torch.from_numpy((rng.standard_normal(s) / np.sqrt(s[0]))
                                .astype(np.float32)).to(dev)

    joint = FactoredAdditiveJoint(wj(hd, hd), wj(hd, hd), 0.1 * wj(hd),
                                  wj(hd, vd), 0.1 * wj(vd))
    pred = partial(gru_step, gp)
    h0 = torch.zeros(hd, device=dev)
    mine = enc[rank * 2:rank * 2 + 2]
    il = torch.full((2,), td, dtype=torch.int32, device=dev)
    _, _, g_sc = rnnt_greedy_decode_data_parallel(
        mine, il, pred, h0, joint, max_symbols=6, lookahead=4)
    b_tok, _, b_sc = rnnt_beam_decode_data_parallel(
        mine, il, pred, h0, joint, beam_width=4, max_symbols=6, lookahead=4)
    sdec = DataParallelStreamingRNNT(StreamingRNNTBeamDecoder(
        pred, h0, joint, beam_width=4, max_symbols=6))
    st = sdec.init(nd, hd)
    st = sdec.step(st, mine[:, :6])
    st = sdec.step(st, mine[:, 6:])
    s_tok, _, _ = sdec.finish(st)
    assert torch.isfinite(g_sc).all() and torch.isfinite(b_sc[:, 0]).all()
    assert torch.equal(s_tok, b_tok), "the streaming decode differs"
    return float(g_sc[0]), float(b_sc[0, 0])


def _rank_main(rank, n_ranks, device, tmp):
    """One rank of the dry run; its results to tmp/rank{rank}.pt."""
    from .time_parallel import ctc_nll_time_parallel

    torch.set_num_threads(1)
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            world_size=n_ranks, rank=rank, timeout=TIMEOUT)
    try:
        d = n_ranks
        loss, spread = _dp_train_step(rank, d, dev)
        rng = np.random.default_rng(1)
        tgt, tl, tp_nll, chunked = _vocab_parallel(rng, d, dev)
        fused = _fused_tp_steps(rng, d, dev)
        greedy, beam = _dp_transducer(rng, rank, d, dev)
        t_sp = 8 * d
        lp_sp = torch.log_softmax(torch.from_numpy(rng.standard_normal(
            (t_sp, 2, 8)).astype(np.float32)), -1).to(dev)
        sp_nll = ctc_nll_time_parallel(lp_sp, (tgt % 7) + 1,
                                       np.full(2, t_sp, np.int32), tl)
        assert torch.isfinite(sp_nll).all()
        torch.save({"jax_free": jax_free(), "device": str(dev),
                    "loss": loss, "spread": spread, "tp_nll": tp_nll,
                    "sp_nll": float(sp_nll[0]), "chunked": chunked,
                    "fused": fused, "greedy": greedy, "beam": beam},
                   f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_ranks: int, *, device=None, tmpdir=None) -> dict:
    """Run the dry run over `n_ranks` spawned gloo ranks (module
    docstring) and print its summary line.  Returns every rank's results
    (`ranks`) and the summary (`line`).  `tmpdir` (default: a fresh
    temporary directory) holds the rendezvous and the results."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory(dir=tmpdir) as tmp:
        mp.spawn(_rank_main, args=(n_ranks, dev.type, tmp), nprocs=n_ranks,
                 join=True)
        ranks = [torch.load(f"{tmp}/rank{r}.pt") for r in range(n_ranks)]
    if not all(r["jax_free"] for r in ranks):
        raise AssertionError("a rank imported JAX, flax or the JAX "
                             "package")
    if any(r["spread"] for r in ranks):
        raise AssertionError("the data-parallel step left the ranks' "
                             "weights apart")
    r0 = ranks[0]
    (f1, f2), (k1, k2) = r0["fused"]
    line = (f"dryrun_multichip ok: ranks={n_ranks} device={r0['device']} "
            f"dp_loss={r0['loss']:.4f} tp_nll={r0['tp_nll']:.3f} "
            f"sp_nll={r0['sp_nll']:.3f} tp_chunked_best={r0['chunked']:.3f} "
            f"tp_rnnt_fused={f1:.3f}->{f2:.3f} "
            f"tp_rnnt_kernel={k1:.3f}->{k2:.3f} "
            f"dp_rnnt_greedy={r0['greedy']:.3f} "
            f"dp_rnnt_beam={r0['beam']:.3f} jax_free=True")
    print(line, flush=True)
    return {"ranks": ranks, "line": line}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_ranks", type=int, nargs="?", default=4)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run the ranks on the CPU (default: the "
                    "card)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_ranks, device=args.device)


if __name__ == "__main__":
    main()
