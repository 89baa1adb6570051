"""step_ms: the engine step, the synchronized wall of a grid's
``engine`` spans (one a static group) over their steps, in ms; the mean
over the window's grids."""


def read(ctx):
    got = [g["engine"] / (g["engine.n"] * ctx.steps) * 1e3
           for g in ctx.grids if "engine" in g]
    return sum(got) / len(got) if got else None
