"""``solve_s`` (s, host clock): the time to a solution, the measured window
(from the first solve's start to the last solve's end, each ending in a
device barrier) over the solves completed in it."""

from benchmark import stats


def read(run):
    return stats.rate(run.window_s, len(run.solves))
