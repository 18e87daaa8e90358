"""idle_ms.dispatch: device-idle milliseconds a mega-batch of the traced
stretch under the program's ``trainer.dispatch`` span (``program_spans``):
the rounds' issue rate."""
from perfbench import program_spans


def read(run):
    return program_spans.idle_ms(run, "trainer.dispatch")
