"""The port's public names against the JAX package's: the port's `__all__`
holds the JAX package's `__all__` less an explicit list of names not
ported yet, each with its ROADMAP.md queue 1 item, so the remaining gap
stays visible (the test prints it); and every shared name, and each
public method of a shared class, takes JAX's parameters in JAX's order
with JAX's defaults, but for the documented extras.  So do the ported
models' public methods and the long-form transcribers, less JAX's
`params`: the port's `nn.Module` holds its parameters itself."""

import inspect

import end2end_tpu
import end2end_tpu.models.pipeline
import end2end_tpu.models.streaming
import end2end_tpu.models.transducer
import end2end_tpu_torch
import end2end_tpu_torch.models.streaming

NOT_YET_PORTED = {  # name: ROADMAP.md queue 1 item
    "__version__": 10,
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
