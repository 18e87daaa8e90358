"""idle_ms.barrier: device-idle milliseconds a mega-batch of the traced
stretch under the program's ``trainer.barrier`` span (``program_spans``):
the guard's and the norms' syncs, the merge's host work and ``_megabatch_result``."""
from perfbench import program_spans


def read(run):
    return program_spans.idle_ms(run, "trainer.barrier")
