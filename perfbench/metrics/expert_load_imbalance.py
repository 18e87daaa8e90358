"""expert_load_imbalance: the held experts' assignments in the traced
stretch, the busiest expert's over the mean expert's (1 is an even load):
the sums of ``load_max`` and of ``load_mean`` over the stretch's
``trainer.barrier`` spans (``program_spans``), whose counters the trainer
files from the MoE layers' device tallies once a mega-batch."""
from perfbench import program_spans


def read(run):
    placed = program_spans.place(run.profile, program_spans.recorded())
    if placed is None:
        return None
    counts = [c for c in placed.started("trainer.barrier") if "load_mean" in c]
    mean = sum(c["load_mean"] for c in counts)
    return sum(c["load_max"] for c in counts) / mean if mean > 0 else None
