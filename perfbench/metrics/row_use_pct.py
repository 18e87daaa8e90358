"""row_use_pct: 100 x the rows the traced stretch's rounds computed that
held a sample, over every row they computed (``trainer.dispatch``'s
``live_rows`` and ``rows``, ``program_spans``): the rest is the padding
of the plan's short and masked slots."""
from perfbench import program_spans


def read(run):
    return program_spans.row_use_pct(run)
