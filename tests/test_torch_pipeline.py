"""The serving slice as a whole: the same waveforms and weights through the
JAX `ConformerCTCPipeline.decode` and the torch port's (CPU, so the plain
versions of the kernels).

Greedy: identical tokens and lengths, scores within 1e-4 (encoder logits
differ by ~1e-6).  Beam: identical best hypotheses, scores within 5e-4 (the
JAX package's kernel-vs-scan tolerance).  Also: long-form stitching, and a
static check that the port never imports JAX.
"""

import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from end2end_tpu.models import streaming as jstream
from end2end_tpu.ops import lm as jlm
from end2end_tpu.ops.beam_search_pallas import beam_search_pallas
from end2end_tpu_torch import ConformerCTCPipeline, PipelineConfig
from end2end_tpu_torch.models import streaming as tstream
from end2end_tpu_torch.ops import lm as tlm

torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def pipes():
    jpipe = graft._tiny_pipeline()
    rng = np.random.default_rng(1)
    wav = rng.standard_normal((3, 4000)).astype(np.float32)
    ns = np.array([4000, 3200, 2400], np.int32)
    params = jax.device_get(jpipe.init(jax.random.key(0), wav, ns))
    tpipe = ConformerCTCPipeline(PipelineConfig(
        vocab_size=16, d_model=64, num_layers=2, num_heads=2, n_mels=16),
        device="cpu")
    tpipe.load_flax_params(params)
    return jpipe, params, tpipe, wav, ns


def test_pipeline_greedy_matches_jax(pipes):
    jpipe, params, tpipe, wav, ns = pipes
    want = [np.asarray(x) for x in jpipe.decode(params, wav, ns)]
    got = [x.numpy() for x in tpipe.decode(wav, ns)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-4, rtol=0)


def test_pipeline_beam_matches_jax(pipes):
    jpipe, params, tpipe, wav, ns = pipes
    want = [np.asarray(x) for x in jpipe.decode(params, wav, ns,
                                                beam_width=4)]
    got = [x.numpy() for x in tpipe.decode(wav, ns, beam_width=4)]
    for b in range(3):
        assert (got[0][b, : got[1][b]].tolist()
                == want[0][b, : want[1][b]].tolist())
    np.testing.assert_allclose(got[2], want[2], atol=5e-4, rtol=0)


def test_pipeline_pruned_beam_matches_kernel(pipes):
    jpipe, params, tpipe, wav, ns = pipes
    logits, out_len = jpipe.encode(params, wav, ns)
    lp = np.asarray(jax.nn.log_softmax(logits, -1)).transpose(1, 0, 2)
    wt, wl, ws = (np.asarray(x) for x in beam_search_pallas(
        lp, np.asarray(out_len), beam_width=4, prune_k=5, interpret=True))
    gt, gl, gs = (x.numpy() for x in tpipe.decode(wav, ns, beam_width=4,
                                                   prune_k=5))
    for b in range(3):
        assert gt[b, : gl[b]].tolist() == wt[b, 0, : wl[b, 0]].tolist()
    np.testing.assert_allclose(gs, ws[:, 0], atol=5e-4, rtol=0)


def test_pipeline_lm_decode_matches_jax(pipes):
    # JAX on the CPU routes an LM decode to its per-frame scan; at
    # prune_k=None (K = V, ks = V) the scan and the port's in-kernel fusion
    # (K5's plain twin here) have the same semantics
    jpipe, params, tpipe, wav, ns = pipes
    rng = np.random.default_rng(5)
    big = jlm.bigram_from_counts(rng.integers(0, 20, (16, 16)))
    st = rng.standard_normal(16).astype(np.float32)
    eos = rng.standard_normal(16).astype(np.float32)
    kw = dict(beam_width=4, lm_alpha=0.7, lm_beta=0.5)
    want = [np.asarray(x) for x in jpipe.decode(
        params, wav, ns, lm=jlm.NGramLM(big, st, eos), **kw)]
    got = [x.numpy() for x in tpipe.decode(
        wav, ns, lm=tlm.NGramLM(big, st, eos, device="cpu"), **kw)]
    plain = tpipe.decode(wav, ns, beam_width=4)
    for b in range(3):
        assert (got[0][b, : got[1][b]].tolist()
                == want[0][b, : want[1][b]].tolist())
    np.testing.assert_allclose(got[2], want[2], atol=5e-4, rtol=0)
    assert not np.allclose(got[2], plain[2].numpy())


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ConformerCTCPipeline(PipelineConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.NGramLM(np.zeros((4, 4), np.float32))
    pipe = ConformerCTCPipeline(PipelineConfig(), device="cpu")
    assert pipe.device.type == "cpu"


def test_long_form_matches_jax(pipes):
    jpipe, params, tpipe, _, _ = pipes
    rng = np.random.default_rng(2)
    long = rng.standard_normal(int(16000 * 1.2)).astype(np.float32)
    chunks, _ = tstream.chunk_waveform(long, 8000, 800)
    assert chunks.shape[0] == 3
    for beam in (0, 4):
        want = jstream.transcribe_long_form(jpipe, params, long, 0.5, 0.05,
                                            beam_width=beam)
        got = tstream.transcribe_long_form(tpipe, long, 0.5, 0.05,
                                           beam_width=beam)
        assert got[1] == want[1]
        assert (got[0][: got[1]].tolist()
                == np.asarray(want[0])[: want[1]].tolist())
        np.testing.assert_allclose(got[2], want[2], atol=5e-4, rtol=0)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_never_imports_jax():
    files = sorted((ROOT / "end2end_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "end2end_tpu"), (
                f"{path.relative_to(ROOT)} imports {mod}")
