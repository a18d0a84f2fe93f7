"""The port's public names against the JAX package's: the port's `__all__`
holds the JAX package's `__all__` less an explicit list of names not
ported yet, each with its ROADMAP.md queue 1 item, so the remaining gap
stays visible (the test prints it); and every shared name, and each
public method of a shared class, takes JAX's parameters in JAX's order
with JAX's defaults, but for the documented extras.  So do the ported
models' public methods and the long-form transcribers, less JAX's
`params`: the port's `nn.Module` holds its parameters itself.  Every
public top-level name of every module of the JAX package is defined in
some module of the port or listed in `TPU_ONLY` with its counterpart or
the reason it has none (an `ast` walk of both trees, nothing imported)."""

import ast
import inspect
from pathlib import Path

import end2end_tpu
import end2end_tpu.models.pipeline
import end2end_tpu.models.streaming
import end2end_tpu.models.transducer
import end2end_tpu_torch
import end2end_tpu_torch.models.streaming

NOT_YET_PORTED = {}  # name: ROADMAP.md queue 1 item

ROOT = Path(__file__).resolve().parent.parent

# JAX's public module-level names with no namesake in the port: name ->
# the port's counterpart, or why it has none (docs/torch_port.md and
# ROADMAP.md's "Don't port" list the same)
TPU_ONLY = {
    # the Pallas wrappers: the port's kernels sit behind *_cuda.py
    "beam_search_pallas": "ops/beam_search_cuda.py (K4-K7 beam_step, "
                          "backtrace), routed by beam_search_decode",
    "beam_search_pallas_from_topk": "ops/beam_search.py::"
                                    "beam_search_from_topk",
    "beam_pallas_supported": "ops/beam_search_cuda.py::beam_supported",
    "ctc_nll_pallas": "ops/ctc_loss_cuda.py::ctc_nll_cuda (K1, K2, the "
                      "combine)",
    "fits_vmem": "a VMEM budget; ops/ctc_loss_cuda.py::alpha_plan and "
                 "beta_plan size the kernels' shared memory",
    "alpha_scan_pallas": "ops/rnnt_loss_cuda.py::alpha (K8)",
    "posteriors_pallas": "ops/rnnt_loss_cuda.py::posteriors (K9)",
    "wavefront_pallas_supported": "ops/rnnt_loss_cuda.py::wavefront_plan "
                                  "(every U + 1)",
    "topk_pallas": "ops/topk_cuda.py::topk (K3)",
    "topk_pallas_fits_vmem": "a VMEM budget; ops/topk_cuda.py::topk_plan",
    # ctc_loss_xla's scans
    "ctc_nll_xla": "ops/ctc_loss_plain.py::ctc_nll_plain",
    "ctc_forward_scan": "ops/ctc_loss_plain.py::forward_scan",
    "ctc_backward_scan": "ops/ctc_loss_plain.py::backward_scan",
    "ctc_forward_scan_ckpt": "ops/ctc_loss_plain.py::forward_scan "
                             "(every=)",
    "ctc_backward_scan_ckpt": "ops/ctc_loss_plain.py::backward_scan "
                              "(every=)",
    # TPU numerics and gathers
    **{name: "fastmath: the TPU's polynomial exp/log; libm's expf and "
             "log1pf meet the float64 criterion (ops/semiring.py)"
       for name in ("exp32", "log1p32", "log32", "log_softmax32",
                    "log_softmax_acc", "logaddexp2_acc", "logaddexp3_acc")},
    "state_onehot": "the MXU's one-hot gather; the port gathers "
                    "(ops/ctc_common.py::gather_lp_ext)",
    "ladder_take": "a TPU gather workaround; ops/indexing.py::flat_take is "
                   "a gather",
    "take1d": "a TPU gather workaround; ops/indexing.py::flat_take is a "
              "gather",
    "safe_clamp": "no caller in the JAX package",
    "make_mesh": "the port's parallel functions take a torch.distributed "
                 "group (default WORLD), what the 1-D mesh stood for",
}

# the port's documented additions to a JAX signature: (owner, parameter)
# -> its kind and default; owner "*" is any name or method
EXTRAS = {
    ("*", "device"): (inspect.Parameter.KEYWORD_ONLY, None),
    ("RNNTLoss", "implementation"): (
        inspect.Parameter.POSITIONAL_OR_KEYWORD, "auto"),
    ("ConformerTransducer", "implementation"): (
        inspect.Parameter.POSITIONAL_OR_KEYWORD, "auto"),
}
# the models' JAX `init` builds a params pytree; the port's nn.Module
# builds its parameters when it is constructed, so `init` has no twin
MODEL_METHODS_WITHOUT_TWIN = {"init"}
# documented defaults that differ: (name, parameter) -> (JAX's, the port's)
DEFAULTS = {
    ("mwer_loss", "score_implementation"): ("xla", "auto"),
    ("mwer_loss_from_nbest", "score_implementation"): ("xla", "auto"),
}


def test_port_exports_the_jax_api_but_the_listed_gap():
    gap = sorted(set(end2end_tpu.__all__) - set(end2end_tpu_torch.__all__))
    print(f"not ported yet ({len(gap)} of {len(end2end_tpu.__all__)}):",
          ", ".join(f"{n} (item {NOT_YET_PORTED.get(n, '?')})" for n in gap))
    assert gap == sorted(NOT_YET_PORTED)


def test_every_exported_name_exists():
    missing = [n for n in end2end_tpu_torch.__all__
               if not hasattr(end2end_tpu_torch, n)]
    assert not missing


def _plain(default):
    """A default compared by value; callables (jnp.tanh against
    torch.tanh) and other objects only by presence."""
    if default is inspect.Parameter.empty or isinstance(
            default, (type(None), bool, int, float, str, tuple)):
        return default
    return "<object>"


def _params(fn, owner):
    """[(name, kind, default)] of fn's signature, the documented extras
    taken out (checked), defaults mapped to JAX's."""
    out = []
    for p in inspect.signature(fn).parameters.values():
        extra = EXTRAS.get((owner, p.name)) or EXTRAS.get(("*", p.name))
        if extra is not None:
            assert (p.kind, p.default) == extra, (owner, p.name)
            continue
        default = p.default
        if (owner, p.name) in DEFAULTS:
            jax_default, port_default = DEFAULTS[(owner, p.name)]
            assert default == port_default, (owner, p.name)
            default = jax_default
        out.append((p.name, p.kind, _plain(default)))
    return out


def _jax_params(fn, drop_params=False):
    """JAX's [(name, kind, default)]; `drop_params` leaves out its
    `params` argument, which the port's modules hold themselves."""
    return [(p.name, p.kind, _plain(p.default))
            for p in inspect.signature(fn).parameters.values()
            if not (drop_params and p.name == "params")]


def _shared_callables():
    """(label, owner, JAX callable, port callable) for every name in both
    `__all__`s and every public method of a shared class."""
    for name in sorted(set(end2end_tpu.__all__)
                       & set(end2end_tpu_torch.__all__)):
        j, t = getattr(end2end_tpu, name), getattr(end2end_tpu_torch, name)
        if not callable(j):
            continue
        yield name, name, j, t
        if inspect.isclass(j):
            for m, fj in inspect.getmembers(j, callable):
                if m.startswith("_") and m != "__init__":
                    continue
                ft = getattr(t, m, None)
                assert ft is not None, f"{name}.{m} is missing"
                yield f"{name}.{m}", name, fj, ft


def test_signatures_match_jax():
    mismatched = []
    for label, owner, j, t in _shared_callables():
        try:
            want = _jax_params(j)
        except (TypeError, ValueError):  # a builtin without a signature
            continue
        if _params(t, owner) != want:
            mismatched.append(label)
    assert not mismatched, mismatched


def _model_callables():
    """(label, owner, JAX callable, port callable) for each public method
    of the ported models and the long-form transcribers."""
    for jmod, tcls in ((end2end_tpu.models.pipeline,
                        end2end_tpu_torch.ConformerCTCPipeline),
                       (end2end_tpu.models.transducer,
                        end2end_tpu_torch.ConformerTransducer)):
        jcls = getattr(jmod, tcls.__name__)
        for m, fj in inspect.getmembers(jcls, callable):
            if m.startswith("_") or m in MODEL_METHODS_WITHOUT_TWIN:
                continue
            ft = getattr(tcls, m, None)
            assert ft is not None, f"{tcls.__name__}.{m} is missing"
            yield f"{tcls.__name__}.{m}", tcls.__name__, fj, ft
    for name in ("transcribe_long_form", "transcribe_long_form_streaming",
                 "transcribe_long_form_rnnt"):
        yield (name, name, getattr(end2end_tpu.models.streaming, name),
               getattr(end2end_tpu_torch.models.streaming, name))


def test_model_and_long_form_signatures_match_jax_less_params():
    labels = []
    mismatched = []
    for label, owner, j, t in _model_callables():
        labels.append(label)
        if _params(t, owner) != _jax_params(j, drop_params=True):
            mismatched.append(label)
    assert "ConformerTransducer.decode" in labels
    assert "transcribe_long_form_rnnt" in labels
    assert not mismatched, mismatched


def _public_names(package: Path) -> dict:
    """{name: [module path]} of the public top-level functions, classes
    and assigned constants of every module under `package`."""
    out = {}
    for path in sorted(package.rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names = [node.name]
            elif isinstance(node, ast.Assign):
                names = [t.id for t in node.targets
                         if isinstance(t, ast.Name)]
            elif (isinstance(node, ast.AnnAssign)
                  and isinstance(node.target, ast.Name)):
                names = [node.target.id]
            else:
                names = []
            for name in names:
                if not name.startswith("_") or name == "__version__":
                    out.setdefault(name, []).append(
                        str(path.relative_to(ROOT)))
    return out


def test_every_jax_name_is_ported_or_tpu_only():
    jax_names = _public_names(ROOT / "end2end_tpu")
    port_names = _public_names(ROOT / "end2end_tpu_torch")
    assert len(jax_names) > 150
    missing = {n: where for n, where in jax_names.items()
               if n not in port_names and n not in TPU_ONLY}
    assert not missing, missing
    # the list holds no name that the port has or JAX lacks
    stale = sorted(n for n in TPU_ONLY
                   if n in port_names or n not in jax_names)
    assert not stale, stale


def test_version_is_jax_version():
    assert end2end_tpu_torch.__version__ == end2end_tpu.__version__
    assert "__version__" in end2end_tpu_torch.__all__
    assert NOT_YET_PORTED == {}
