"""The port's spans (`utils/profiling.span`) and the benchmark's reader of
them (`e2e_bench/spans.py`), on the CPU.

Tiny models run under torch.profiler: each span appears where the port's
layer map puts it, nested as it says, every forward op of a root span lies
under a span and every backward node maps to one.  Without a profiler a
span is one shared null context.  A small synthetic Chrome trace, with
kernels tied to their launches by `correlation`, two host threads, backward
nodes and synchronising calls, pins down the reader's attribution of
device time, idle time and syncs, and shows that the benchmark's existing
readers read the same whether the port's spans are in the trace or not.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from e2e_bench import harness, spans
from e2e_bench import trace as trace_mod
from e2e_bench.tests.tiny import ROOT
from end2end_tpu_torch.models.conformer import ConformerEncoder
from end2end_tpu_torch.models.frontend import (log_mel_spectrogram,
                                               num_frames)
from end2end_tpu_torch.models.pipeline import (ConformerCTCPipeline,
                                               PipelineConfig)
from end2end_tpu_torch.models.transducer import (ConformerTransducer,
                                                 TransducerConfig)
from end2end_tpu_torch.utils import profiling

# each span and the port span it nests in (None: a root, or called from
# outside the port's roots, as the benchmark calls the transducer's
# frontend)
PARENTS = {
    "ctc_pipeline.loss": None, "ctc_pipeline.decode": None,
    "transducer.loss": None,
    "encoder.subsample": "encoder", "encoder.blocks": "encoder",
    "ctc.loss": "ctc_pipeline.loss",
    "rnnt.predictor": "transducer.loss", "rnnt.joint": "transducer.loss",
    "rnnt.loss": "transducer.loss",
    "ctc.greedy": "ctc_pipeline.decode", "ctc.beam": "ctc_pipeline.decode",
    "ctc.beam.topk": "ctc.beam", "ctc.beam.step": "ctc.beam",
    "ctc.beam.backtrace": "ctc.beam",
}
ROOTS = {"ctc_pipeline.loss", "ctc_pipeline.decode", "transducer.loss"}
CTC = PipelineConfig(vocab_size=12, d_model=32, num_layers=2, num_heads=2,
                     n_mels=16)
RNNT = TransducerConfig(vocab_size=12, n_mels=16, d_model=32, num_layers=2,
                        num_heads=2, enc_dim=16, emb_dim=8, pred_hidden=16,
                        joint_dim=16)


def _ctc():
    return ConformerCTCPipeline(CTC, device="cpu",
                                generator=torch.Generator().manual_seed(0))


def _inputs():
    g = torch.Generator().manual_seed(1)
    wave = torch.randn(2, 4000, generator=g)
    return (wave, torch.tensor([4000, 3000]),
            torch.randint(1, 12, (2, 3), generator=g), torch.tensor([3, 2]))


def _ctc_loss():
    wave, n, tgt, tl = _inputs()
    with record_function("train.forward"):
        loss = _ctc().loss(wave, n, tgt, tl)
    with record_function("train.backward"):
        loss.backward()


def _transducer_loss():
    wave, n, tgt, tl = _inputs()
    model = ConformerTransducer(RNNT, device="cpu")
    with record_function("train.forward"):
        feats = log_mel_spectrogram(wave, 16000, 400, 160, 16)
        loss = model.loss(feats, num_frames(n), tgt, tl)
    with record_function("train.backward"):
        loss.backward()


def _decode(beam):
    def run():
        wave, n, _, _ = _inputs()
        with record_function("decode.model"):
            _ctc().decode(wave, n, beam_width=beam, prune_k=4)
    return run


PROGRAMS = {
    "ctc_loss": (_ctc_loss, {"ctc_pipeline.loss", "frontend", "encoder",
                             "encoder.subsample", "encoder.blocks",
                             "ctc.loss"}),
    "transducer_loss": (_transducer_loss, {
        "transducer.loss", "frontend", "encoder", "encoder.subsample",
        "encoder.blocks", "rnnt.predictor", "rnnt.joint", "rnnt.loss"}),
    "greedy": (_decode(0), {"ctc_pipeline.decode", "frontend", "encoder",
                            "encoder.subsample", "encoder.blocks",
                            "ctc.greedy"}),
    "beam": (_decode(4), {"ctc_pipeline.decode", "frontend", "encoder",
                          "encoder.subsample", "encoder.blocks", "ctc.beam",
                          "ctc.beam.topk", "ctc.beam.step",
                          "ctc.beam.backtrace"}),
}


def _profiled(fn, path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("e2e.slice"):
            fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    out = {}
    for name, (fn, _) in PROGRAMS.items():
        path = tmp_path_factory.mktemp(name) / "trace.json"
        out[name] = (path, _profiled(fn, path))
    return out


def _parent(events, span):
    """The innermost port span around `span` on its thread."""
    around = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"] in spans.PORT and e is not span
              and e["tid"] == span["tid"] and e["ts"] <= span["ts"]
              and span["ts"] + span["dur"] <= e["ts"] + e["dur"]]
    return min(around, key=lambda e: e["dur"])["name"] if around else None


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_each_span_appears_once_and_nests_as_the_layer_map_says(traced,
                                                                program):
    _, events = traced[program]
    mine = [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] in spans.PORT]
    assert sorted(e["name"] for e in mine) == sorted(PROGRAMS[program][1])
    for e in mine:
        if e["name"] == "encoder":
            expect = {"ctc_loss": "ctc_pipeline.loss",
                      "transducer_loss": "transducer.loss"}.get(
                          program, "ctc_pipeline.decode")
        elif e["name"] == "frontend":
            expect = {"ctc_loss": "ctc_pipeline.loss",
                      "transducer_loss": None}.get(program,
                                                   "ctc_pipeline.decode")
        else:
            expect = PARENTS[e["name"]]
        assert _parent(events, e) == expect, e["name"]


def test_the_programs_record_every_span_the_reader_knows():
    assert set().union(*(s for _, s in PROGRAMS.values())) == spans.PORT


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_forward_ops_lie_under_a_span_and_backward_nodes_map_to_one(
        traced, program):
    _check_ops_and_nodes(*traced[program], program)


@pytest.mark.parametrize("program", ["ctc_loss", "transducer_loss"])
def test_the_packed_encoder_keeps_ops_and_nodes_under_spans(
        tmp_path, monkeypatch, program):
    """The encoder packs on the card alone; forced to pack here, its
    scatters and gathers lie under the spans and their backward nodes map
    to one, as the padded path's do."""
    packed = []

    def forward(enc, feats, lengths):
        out = enc.forward_packed(feats, lengths)
        packed.append(enc.packing["packed"])
        return out

    monkeypatch.setattr(ConformerEncoder, "forward", forward)
    path = tmp_path / "trace.json"
    _check_ops_and_nodes(path, _profiled(PROGRAMS[program][0], path),
                         program)
    assert packed == [1]


def _check_ops_and_nodes(path, events, program):
    st = spans.SpanTrace(path)
    roots = [e for e in events if e["name"] in ROOTS]
    nodes = [e for e in events
             if e["name"].startswith("autograd::engine::evaluate_function")]
    # decoding runs without autograd: its ops carry no sequence number
    graded = program.endswith("loss")
    fwd = [e for e in events if e.get("cat") == "cpu_op"
           and (e.get("args", {}).get("Sequence number", -1) >= 0
                or not graded)
           and e not in nodes
           and not any(n["ts"] <= e["ts"] < n["ts"] + n["dur"]
                       for n in nodes)
           and any(r["ts"] <= e["ts"] < r["ts"] + r["dur"] for r in roots)]
    assert fwd
    for e in fwd:
        assert st.label((e["pid"], e["tid"]), e["ts"]) in spans.PORT, e
    made = [n for n in nodes
            if n.get("args", {}).get("Sequence number", -1) >= 0]
    assert bool(made) == graded
    for n in made:
        label = st.label((n["pid"], n["tid"]), n["ts"] + n["dur"] / 2)
        assert label.endswith(".backward") and spans.is_port(label), n
    if program == "transducer_loss":
        seen = {st.label((n["pid"], n["tid"]), n["ts"] + n["dur"] / 2)
                for n in made}
        assert {"rnnt.predictor.backward", "rnnt.joint.backward",
                "encoder.subsample.backward",
                "encoder.blocks.backward"} <= seen


def test_without_a_profiler_a_span_is_one_shared_null_context(monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert profiling.span("encoder") is profiling.span("ctc.beam")
    with profiling.span("encoder") as inside:
        assert inside is None

    def refuse(name):
        raise AssertionError(f"a range was opened for {name}")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    wave, n, tgt, tl = _inputs()
    pipe = _ctc()
    pipe.loss(wave, n, tgt, tl).backward()
    pipe.decode(wave, n, beam_width=4)
    model = ConformerTransducer(RNNT, device="cpu")
    feats = log_mel_spectrogram(wave, 16000, 400, 160, 16)
    model.loss(feats, num_frames(n), tgt, tl).backward()


def test_under_a_profiler_a_span_is_a_range(tmp_path):
    events = _profiled(lambda: profiling.span("encoder").__enter__(),
                       tmp_path / "t.json")
    assert any(e["name"] == "encoder" and e.get("cat") == "user_annotation"
               for e in events)


# -- the reader on a synthetic trace -----------------------------------------
MAIN, BWD = (1, 10), (1, 20)


def _x(cat, name, th, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": th[0], "tid": th[1],
            "ts": ts, "dur": dur, "args": args}


def _synthetic(with_port_spans=True):
    """One training step's worth, in microseconds: the forward on MAIN, the
    backward nodes on BWD, eight device operations."""
    ua = "user_annotation"
    host = [
        _x(ua, "e2e.slice", MAIN, 0, 1000),
        _x(ua, "train.forward", MAIN, 10, 390),
        _x(ua, "train.backward", MAIN, 400, 500),
        _x(ua, "train.optimizer", MAIN, 900, 90),
        _x(ua, "Optimizer.step#AdamW.step", MAIN, 905, 80),  # torch's own
    ]
    port = [
        _x(ua, "ctc_pipeline.loss", MAIN, 20, 370),
        _x(ua, "encoder", MAIN, 30, 270),
        _x(ua, "encoder.subsample", MAIN, 40, 60),
    ]
    ops = [
        _x("cpu_op", "aten::conv2d", MAIN, 50, 10, **{"Sequence number": 5}),
        _x("cpu_op", "aten::add", MAIN, 200, 10, **{"Sequence number": 6}),
        _x("cpu_op", "autograd::engine::evaluate_function: "
           "ConvolutionBackward0", BWD, 500, 50, **{"Sequence number": 5}),
        _x("cpu_op", "autograd::engine::evaluate_function: AddBackward0",
           BWD, 600, 50, **{"Sequence number": 6}),
        _x("cpu_op", "AddBackward0", BWD, 601, 40, **{"Sequence number": 6}),
        _x("cpu_op", "autograd::engine::evaluate_function: "
           "torch::autograd::AccumulateGrad", BWD, 660, 10),
    ]
    rt = "cuda_runtime"
    calls = [
        _x(rt, "cudaLaunchKernel", MAIN, 55, 3, correlation=1),
        _x(rt, "cudaLaunchKernel", MAIN, 205, 3, correlation=2),
        _x(rt, "cudaStreamSynchronize", MAIN, 250, 40, correlation=3),
        _x(rt, "cudaMemcpyAsync", MAIN, 260, 3, correlation=4),
        _x(rt, "cudaLaunchKernel", BWD, 510, 3, correlation=5),
        _x(rt, "cudaMemcpy", BWD, 610, 5, correlation=9),
        _x(rt, "cudaLaunchKernel", BWD, 620, 3, correlation=6),
        _x(rt, "cudaLaunchKernel", BWD, 665, 3, correlation=7),
        _x(rt, "cudaStreamSynchronize", MAIN, 902, 2, correlation=10),
        _x(rt, "cudaLaunchKernel", MAIN, 906, 3, correlation=8),
    ]
    gpu = (0, 7)
    device = [
        _x("kernel", "ctc_alpha_kernel", gpu, 120, 30, correlation=1),
        _x("kernel", "void at::native::vectorized_elementwise_kernel<4>()",
           gpu, 150, 30, correlation=2),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", gpu, 290, 5,
           correlation=4),
        _x("kernel", "sm80_xmma_wgrad_implicit_gemm", gpu, 520, 40,
           correlation=5),
        _x("kernel", "ctc_beta_kernel", gpu, 630, 70, correlation=6),
        _x("kernel", "void at::native::reduce_kernel<512, 1>()", gpu, 700,
           20, correlation=7),
        _x("kernel", "void at::native::multi_tensor_apply_kernel()", gpu,
           910, 50, correlation=8),
        _x("gpu_memset", "Memset (Device)", gpu, 970, 10, correlation=99),
    ]
    events = host + (port if with_port_spans else []) + ops + calls + device
    return {"traceEvents": events}


@pytest.fixture
def synthetic(tmp_path):
    def write(with_port_spans=True):
        path = tmp_path / f"synthetic{int(with_port_spans)}.json"
        path.write_text(json.dumps(_synthetic(with_port_spans)))
        return path
    return write


def test_device_ops_go_to_the_span_open_at_their_launch(synthetic):
    st = spans.SpanTrace(synthetic())
    assert st.op_labels() == [
        "encoder.subsample", "encoder", "encoder",
        "encoder.subsample.backward", "encoder.backward",
        "train.backward",    # AccumulateGrad: no sequence number
        "train.optimizer",   # under no port span
        None]                # its launch is not in the trace
    assert st.device_s()[None] == pytest.approx(10e-6)
    assert sum(st.device_s().values()) == pytest.approx(255e-6)


def test_idle_goes_to_the_span_open_on_the_launching_thread(synthetic):
    idle = spans.SpanTrace(synthetic()).idle_s()
    expect = {None: 20, "train.forward": 115, "ctc_pipeline.loss": 10,
              "encoder": 140, "encoder.subsample": 60,
              "encoder.subsample.backward": 20, "train.backward": 280,
              "encoder.backward": 70, "train.optimizer": 30}
    assert set(idle) == set(expect)
    for k, v in expect.items():
        assert idle[k] == pytest.approx(v * 1e-6), k
    assert sum(idle.values()) == pytest.approx(745e-6)


def test_syncs_count_inside_port_spans_only(synthetic):
    st = spans.SpanTrace(synthetic())
    assert dict(st.port_syncs()) == {"encoder": 1, "encoder.backward": 1}
    assert sorted(str(lb) for lb, *_ in st.sync_labels()) == [
        "encoder", "encoder.backward", "train.optimizer"]


def test_idle_of_backward_gaps_splits_by_span(synthetic):
    path = synthetic()
    st = spans.SpanTrace(path)
    base = trace_mod.Trace(path, set())
    back = st.idle_s(lambda g: base._label(g[0]) == "train.backward")
    assert dict(back) == pytest.approx({"train.backward": 180e-6,
                                        "encoder.backward": 70e-6,
                                        "train.optimizer": 10e-6})


def test_gaps_match_the_trace_idle(synthetic):
    path = synthetic()
    base = trace_mod.Trace(path, set())
    idle = sum(b - a for a, b in spans.gaps(base.ops, base.t0, base.t1))
    assert idle * 1e-6 == pytest.approx(base.window_s - base.busy_s)


def test_port_idle_share_reads_every_thread_as_one(synthetic):
    with_spans = trace_mod.Trace(synthetic(), set())
    assert spans.port_idle_share(with_spans) == pytest.approx(30.5)
    assert spans.port_idle_share(trace_mod.Trace(synthetic(False),
                                                 set())) is None


def _works():
    return [{"audio_s": 2.0, "flops": 3e9, "latencies_s": [0.1, 0.2],
             "bounds": {"ctc_loss": 1e-3, "rnnt_loss": 2e-3, "beam": 5e-4}}]


NEW = {"idle.port.decode"}  # the metrics that read the port's spans


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_existing_readers_read_the_same_with_the_port_spans(synthetic, kind):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    port = trace_mod.port_kernels(ROOT / "end2end_tpu_torch" / "csrc")
    runs = [harness.Run(kind, works=_works(), slice_works=_works(),
                        trace=trace_mod.Trace(synthetic(flag), port))
            for flag in (True, False)]
    read = 0
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            continue
        fn = harness.reader(ROOT, m["name"])
        a, b = fn(runs[0]), fn(runs[1])
        assert a == b, m["name"]
        read += a is not None
    assert read >= 5
    idle = harness.reader(ROOT, f"idle.{kind}")(runs[0])
    assert idle == pytest.approx(74.5)
    launches = harness.reader(ROOT, f"launches.{kind}")(runs[0])
    assert launches == pytest.approx(8 / 2.0)


def test_the_new_metric_reads_the_port_idle_and_nothing_without_spans(
        synthetic):
    read = harness.reader(ROOT, "idle.port.decode")
    runs = [harness.Run("decode", works=_works(), slice_works=_works(),
                        trace=trace_mod.Trace(synthetic(flag), set()))
            for flag in (True, False)]
    assert read(runs[0]) == pytest.approx(30.5)
    assert read(runs[1]) is None
    assert read(harness.Run("train", trace=runs[0].trace)) is None


def test_timeline_cuts_an_inner_range_at_the_outer_end():
    line = spans.Timeline([(0, 10, "a"), (2, 5, "b"), (3, 4, "c"),
                           (8, 12, "d"), (20, 30, "e")])
    assert line.segs == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 5, "b"),
                         (5, 8, "a"), (8, 10, "d"), (20, 30, "e")]
    assert [line.at(t) for t in (3.5, 5, 11, 15)] == ["c", "a", None, None]
    parts, rest = line.split(1, 25)
    assert dict(parts) == {"a": 4, "b": 2, "c": 1, "d": 2, "e": 5}
    assert rest == [(10, 20)]


def test_the_report_runs_a_tiny_cell_on_the_cpu():
    from e2e_bench import span_report
    from e2e_bench.tests import tiny

    out = span_report.report(tiny.cell("transducer-large.train"), 2**31 + 7,
                             torch.device("cpu"))
    assert out["steps"] == 2 and out["tracing_cost"] > -1
    assert set(out["spans_a_step"]) == PROGRAMS["transducer_loss"][1]
    assert set(out["readings"]) == {
        "host_syncs.train.transducer", "idle.predictor.train.transducer",
        "joint_ms.train.transducer"}
    assert out["readings"]["host_syncs.train.transducer"] == 0.0
