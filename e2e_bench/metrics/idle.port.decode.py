"""Share of the traced decode window that is idle while one of the port's
spans is the innermost range open on the host, %; the rest of
`idle.decode` is the client's (its result copy, its loop).  None where the
port records no span."""

from e2e_bench import spans


def read(run):
    if run.kind != "decode" or run.trace is None:
        return None
    return spans.port_idle_share(run.trace)
