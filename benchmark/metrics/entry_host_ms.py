"""Host time of the entry per request, in ms: the benchmark's span around
the call less the solver's phases that ``utils.profiling.phase`` recorded in
it (``rref+origin`` and, where they occur, ``pad``, ``h2d``, ``extract``,
``rref``), averaged over the traced requests."""

SOLVER_PHASES = ("rref+origin", "rref", "pad", "h2d", "extract")


def read(ctx):
    if not ctx.requests:
        return None
    own = [r.seconds - sum(r.phases.get(p, 0.0) for p in SOLVER_PHASES) for r in ctx.requests]
    return 1000 * sum(own) / len(own)
