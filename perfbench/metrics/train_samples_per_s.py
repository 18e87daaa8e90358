"""train_samples_per_s: the training samples of every mega-batch the
window completed, over the window's seconds (host clock)."""


def read(run):
    return run.samples / run.window_s
