"""The plain reference the benchmark holds ``repro_torch`` to: plain numpy
(``host``) and plain PyTorch (``mlp``), importing nothing of the program,
and the comparison that decides ``correct`` (``check``)."""
