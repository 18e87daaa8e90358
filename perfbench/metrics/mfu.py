"""mfu: the model FLOPs of the samples the window completed (forward and
backward of the MLP from its widths and each sample's nnz, no recomputed
work) over the window's seconds x chips x the peak of the configuration's
dtype, in %."""


def read(run):
    peak = run.config["peak_flops"] * run.chips * run.window_s
    return 100.0 * run.model_flops / peak if run.on_card else None
