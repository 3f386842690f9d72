"""``solve_p90_s`` (s, host clock): the 90th percentile of the wall time
of every solve in the window."""

from benchmark import stats


def read(run):
    return stats.percentile([s.wall_s for s in run.solves], 90)
