"""score_s: the scoring, per grid: each ``group`` span (engine run and
scoring of every cell) less its ``engine`` span; the mean over the
window's grids."""


def read(ctx):
    got = [g["group"] - g["engine"] for g in ctx.grids
           if "group" in g and "engine" in g]
    return sum(got) / len(got) if got else None
