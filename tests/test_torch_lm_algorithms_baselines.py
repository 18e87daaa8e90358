"""LM training, the port's trainer against a live reference trainer
(``tests/torch_lm_runs.py`` has the runs, the settings and the
tolerances), on reduced llama3.2-1b in f32: the five algorithms of the
registry besides Adaptive SGD, and Adaptive SGD on the sequential path
(``overlap=False``)."""
from __future__ import annotations

import pytest

from torch_lm_runs import (  # noqa: F401 (one_thread: a fixture)
    F32_TOL, assert_runs_match, one_thread, run_port, run_ref,
)

ARCH = "llama3.2-1b"

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("algo", ("crossbow", "delayed_sync", "elastic", "single", "sync"))
def test_algorithm_matches_reference(algo):
    assert_runs_match(run_port(algo, ARCH), run_ref(algo, ARCH), F32_TOL)


def test_sequential_path_matches_reference():
    assert_runs_match(run_port("adaptive", ARCH, overlap=False),
                      run_ref("adaptive", ARCH, overlap=False), F32_TOL)
