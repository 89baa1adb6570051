"""build_s: the grid build, per grid: the summed ``build`` spans (world,
traffic, engine build and merge of each static group), host clock,
synchronized; the mean over the window's grids."""


def read(ctx):
    got = [g["build"] for g in ctx.grids if "build" in g]
    return sum(got) / len(got) if got else None
