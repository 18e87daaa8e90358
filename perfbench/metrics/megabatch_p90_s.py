"""megabatch_p90_s: the 90th percentile of the wall time between
consecutive mega-batch completions, the first from the window's start,
over every mega-batch of the window (host clock; evaluations included)."""
import numpy as np


def read(run):
    return float(np.percentile(np.diff([0.0] + run.completions), 90))
