"""Traffic: the generator of the training pool, and one data file of run
parameters a traffic mix (``<traffic>.json``)."""
