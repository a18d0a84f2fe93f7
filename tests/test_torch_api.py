"""The port's public names against the JAX package's: the port's `__all__`
holds the JAX package's `__all__` less an explicit list of names not
ported yet, each with its ROADMAP.md queue 1 item, so the remaining gap
stays visible (the test prints it); and every shared name, and each
public method of a shared class, takes JAX's parameters in JAX's order
with JAX's defaults, but for the documented extras."""

import inspect

import end2end_tpu
import end2end_tpu_torch

NOT_YET_PORTED = {  # name: ROADMAP.md queue 1 item
    "StreamingBeamDecoder": 5,
    "StreamingGreedyDecoder": 5,
    "StreamingRNNTBeamDecoder": 7,
    "StreamingRNNTGreedyDecoder": 7,
    "rnnt_greedy_decode_with_confidence": 7,
    "rnnt_mwer_loss": 7,
    "rnnt_token_confidence": 7,
    "__version__": 10,
}

# the port's documented additions to a JAX signature: (owner, parameter)
# -> its kind and default; owner "*" is any name or method
EXTRAS = {
    ("*", "device"): (inspect.Parameter.KEYWORD_ONLY, None),
    ("RNNTLoss", "implementation"): (
        inspect.Parameter.POSITIONAL_OR_KEYWORD, "auto"),
}
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


def _jax_params(fn):
    return [(p.name, p.kind, _plain(p.default))
            for p in inspect.signature(fn).parameters.values()]


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
