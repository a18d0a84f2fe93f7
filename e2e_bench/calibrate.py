"""The readings that a cell's limits are set from (`limits/<cell>.json`).

    python3 e2e_bench/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--controls 3] [--batches 12] [--out FILE]

For each seed, in one process: the port's readings of the checked steps
(training) or of a short closed-loop window of `--batches` batches
(serving), each held against the reference as a run holds them.  For the
first `--controls` seeds also:
  * control: the reference in the port's place in TF32 (the card's TF32
    switches on; elsewhere operands rounded to TF32);
  * training: half_batch (the reference on each batch's first half, the
    mean over it) and unchanged (the port's state left as it was);
  * serving: token_altered (a token of each served transcript changed),
    half_batch (half of the requests left without an answer) and, for
    beam search, outranked (the reference's second beam served).
Training lines also carry every leaf's gradient and change norms under
each reading (`leaves`), from which the limits are set.
One JSON line a seed on standard output (and appended to `--out`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0]).resolve() == ROOT / "e2e_bench":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from e2e_bench import compare, harness  # noqa: E402
from e2e_bench.reference import ctc as ref_ctc  # noqa: E402
from e2e_bench.reference.conformer import Precision  # noqa: E402


def train(cell, seed, dev, controls: bool) -> dict:
    e = cell.entry.Entry(cell.cfg, cell.mix, seed, dev)
    e.setup(warm=False)
    e.free()
    ref = e.reference_readings(Precision(False))
    out = {"program": compare.train_numbers(e.readings, ref),
           "detail": compare.train_detail(e.readings, ref)}
    leaves = {"reference": ref, "program": e.readings}
    if controls:
        tf32 = Precision(True, on_card=dev.type == "cuda")
        ctl = e.reference_readings(tf32)
        out["control"] = compare.train_numbers(ctl, ref)
        out["control_detail"] = compare.train_detail(ctl, ref)
        half = e.reference_readings(Precision(False), half=True)
        out["half_batch"] = compare.train_numbers(half, ref)
        still = {**e.readings, "changes": {k: 0.0 for k in e.readings[
            "changes"]}}
        out["unchanged"] = compare.train_numbers(still, ref)
        leaves.update(control=ctl, half_batch=half)
    # every leaf's first-gradient and change norms, by reading
    out["leaves"] = {k: {who: [r["grads"][k], r["changes"][k]]
                         for who, r in leaves.items()}
                     for k in ref["grads"]}
    return out


def _altered(tokens, v):
    if not tokens:
        return [1]
    i = len(tokens) // 2
    return tokens[:i] + [tokens[i] % (v - 1) + 1] + tokens[i + 1:]


def _ranked(lp, beam, blank, s_cap, rank: int):
    """The reference's beam of that rank (or its last), as served."""
    hyps = compare.beam_search(lp, beam, blank, s_cap)
    tokens, score = hyps[min(rank, len(hyps) - 1)]
    return list(tokens), score


def serve(cell, seed, dev, controls: bool, batches: int) -> dict:
    e = cell.entry.Entry(cell.cfg, cell.mix, seed, dev)
    e.setup(warm=False)
    for k in range(batches):
        e.step(k)
    e.free()
    t0 = time.perf_counter()
    picks = e.sample()
    served, caps = e.served_outputs(picks), e.s_caps(picks)
    blank, beam = cell.cfg["blank"], (cell.mix["decode"] if e.beam else None)
    lps = e.reference_log_probs(picks, Precision(False))
    notes = {}
    out = {"program": compare.serve_numbers(served, lps, beam, blank, caps,
                                            notes),
           "check_s": time.perf_counter() - t0, **notes}
    if controls:
        lpc = e.reference_log_probs(
            picks, Precision(True, on_card=dev.type == "cuda"))
        if beam:
            ctl = [_ranked(lp, beam, blank, cap, 0)
                   for lp, cap in zip(lpc, caps)]
        else:
            ctl = [(ref_ctc.collapse(lp.argmax(1), blank),
                    ref_ctc.best_path_score(lp)) for lp in lpc]
        v = cell.cfg["vocab_size"]
        faults = {
            "control": ctl,
            "token_altered": [(_altered(t, v), s) for t, s in served],
            "half_batch": [(t, s) if i % 2 == 0 else ([], 0.0)
                           for i, (t, s) in enumerate(served)]}
        if beam:  # the reference's second beam served in place of its best
            faults["outranked"] = [_ranked(lp, beam, blank, cap, 1)
                                   for lp, cap in zip(lps, caps)]
        for name, outputs in faults.items():
            out[name] = compare.serve_numbers(outputs, lps, beam, blank, caps)
    out["tokens"] = [len(t) for t, _ in served]
    out["frames"] = [lp.shape[0] for lp in lps]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cell = harness.load_cell(ROOT, args.workload)
    dev = torch.device(args.device)
    harness.apply_precision(cell.cfg)
    for i, seed in enumerate(args.seeds):
        controls = i < args.controls
        if cell.entry.KIND == "train":
            r = train(cell, seed, dev, controls)
        else:
            r = serve(cell, seed, dev, controls, args.batches)
        line = json.dumps({"workload": args.workload, "seed": seed, **r},
                          default=float)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
