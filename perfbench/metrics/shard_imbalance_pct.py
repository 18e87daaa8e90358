"""shard_imbalance_pct: (max - min) / max of the shards' windows
(``ShardWindowTimer``, CUDA events on each shard's stream), as they reach
``MeasuredSpeedModel.observe_shards``, the mean a mega-batch over the
window."""


def read(run):
    w = [x for x in run.shard_windows if len(x) > 1]
    if not w:
        return None
    return 100.0 * sum((x.max() - x.min()) / x.max() for x in w) / len(w)
