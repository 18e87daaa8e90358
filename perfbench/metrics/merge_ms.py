"""merge_ms: the benchmark's span around the algorithm's merge (Alg. 2,
the barrier), closed by a synchronise of every card; the mean a
mega-batch over the traced run's window."""


def read(run):
    return 1e3 * sum(run.merge_s) / len(run.merge_s) if run.merge_s else None
