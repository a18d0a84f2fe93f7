"""`parallel.sharding.sum_gradients` on 2 gloo ranks on the CPU: each rank
runs a tiny Conformer-CTC pipeline on its half of a batch through
`ctc_loss_data_parallel` (the whole batch's mean), `backward()` and
`sum_gradients` in small buckets; every rank's summed gradients equal one
process's gradient of the whole batch (to float32's rounding of the sum's
other order), and the ranks' are bit-equal."""

import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from end2end_tpu_torch.models.pipeline import (ConformerCTCPipeline,
                                               PipelineConfig)
from end2end_tpu_torch.parallel import ctc_loss_data_parallel, sum_gradients

D = 2
CFG = PipelineConfig(vocab_size=12, d_model=32, num_layers=1, num_heads=2,
                     n_mels=16)


def _pipe():
    return ConformerCTCPipeline(CFG, device="cpu",
                                generator=torch.Generator().manual_seed(0))


def _batch():
    g = torch.Generator().manual_seed(1)
    wave = torch.randn(4, 4000, generator=g)
    return (wave, torch.tensor([4000, 3000, 2500, 3600]),
            torch.randint(1, 12, (4, 3), generator=g),
            torch.tensor([3, 2, 3, 1]))


def _loss(pipe, wave, n, tgt, tl, group=None):
    logits, out_len = pipe.encode(wave, n)
    lp = torch.log_softmax(logits, dim=-1).transpose(0, 1)
    return ctc_loss_data_parallel(lp, tgt, out_len, tl, group,
                                  zero_infinity=True)


def _rank(rank, tmp):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                            world_size=D, rank=rank)
    try:
        pipe = _pipe()
        rows = slice(rank * 2, rank * 2 + 2)
        _loss(pipe, *(x[rows] for x in _batch())).backward()
        sum_gradients(pipe, bucket_numel=20_000)
        torch.save({k: p.grad for k, p in pipe.named_parameters()},
                   f"{tmp}/grads{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_summed_gradients_are_the_whole_batch_gradient():
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(tmp,), nprocs=D, join=True)
        got = [torch.load(Path(tmp, f"grads{r}.pt")) for r in range(D)]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv",
                                world_size=1, rank=0)
        try:
            pipe = _pipe()
            _loss(pipe, *_batch()).backward()
        finally:
            dist.destroy_process_group()
    want = {k: p.grad for k, p in pipe.named_parameters()}
    assert set(got[0]) == set(want)
    # a key's bias reads rounding alone (softmax cancels it): the scale is
    # the largest gradient element of any leaf
    scale = max(g.abs().max().item() for g in want.values())
    for k, g in want.items():
        assert torch.equal(got[0][k], got[1][k]), k
        torch.testing.assert_close(got[0][k], g, rtol=1e-5,
                                   atol=1e-6 * scale, msg=k)
