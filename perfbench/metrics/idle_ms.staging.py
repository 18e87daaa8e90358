"""idle_ms.staging: device-idle milliseconds a mega-batch of the traced
stretch under the program's ``trainer.stage`` span (``program_spans``):
staging the device waited for: the part of ``host_stage_ms`` the pipeline does not hide."""
from perfbench import program_spans


def read(run):
    return program_spans.idle_ms(run, "trainer.stage")
