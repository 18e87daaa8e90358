"""The four small host helpers the port copies from the reference, each
held to the reference's own on the same inputs: ``make_paper_like`` (the
paper-scale XML stand-ins), ``RunConfig``, ``MegaBatchPlan.
per_round_sizes`` and the dict interface of ``TrainableModel``."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.configs.base import RunConfig as JRunConfig
from repro.core.scheduler import Dispatch as JDispatch
from repro.core.scheduler import MegaBatchPlan as JPlan
from repro.data.xml_synth import make_paper_like as jmake_paper_like
from repro.models.protocol import TrainableModel as JModel
from repro_torch.configs.base import RunConfig
from repro_torch.core.scheduler import Dispatch, MegaBatchPlan
from repro_torch.data.xml_synth import make_paper_like
from repro_torch.models.protocol import TrainableModel


@pytest.mark.parametrize("which,scale", [("amazon-670k", 0.002), ("delicious-200k", 0.001)])
def test_make_paper_like_matches_reference(which, scale):
    got = make_paper_like(which, scale=scale, n_samples=256, seed=3)
    want = jmake_paper_like(which, scale=scale, n_samples=256, seed=3)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_make_paper_like_rejects_unknown():
    with pytest.raises(KeyError):
        make_paper_like("eurlex-4k")


def test_run_config_matches_reference():
    assert dataclasses.asdict(RunConfig()) == dataclasses.asdict(JRunConfig())
    kw = dict(seq_len=128, global_batch=8, mode="prefill", warmup_megabatches=2)
    assert dataclasses.asdict(RunConfig(**kw)) == dataclasses.asdict(JRunConfig(**kw))
    with pytest.raises(dataclasses.FrozenInstanceError):
        RunConfig().lr = 1.0


def test_per_round_sizes_matches_reference():
    rng = np.random.default_rng(0)
    rows = [(int(r), int(rd), int(n)) for r, rd, n in zip(
        rng.integers(0, 4, 12), rng.integers(0, 5, 12), rng.integers(1, 33, 12))]
    plans = []
    for D, P in ((Dispatch, MegaBatchPlan), (JDispatch, JPlan)):
        ds = [D(replica=r, round=rd, n_samples=n, start_t=0.0, end_t=1.0) for r, rd, n in rows]
        plans.append(P(dispatches=ds, u=np.zeros(4, np.int64), n_rounds=5, barrier_time=1.0,
                       samples=sum(n for *_, n in rows)))
    got, want = plans[0].per_round_sizes(4), plans[1].per_round_sizes(4)
    assert got.dtype == want.dtype and got.shape == (5, 4)
    np.testing.assert_array_equal(got, want)


def _fns():
    return (lambda g: {"w": 1}), (lambda p, b: (0.0, {})), (lambda p, b: ((0.0, {}), {}))


@pytest.mark.parametrize("with_sparse", [True, False])
def test_trainable_model_dict_interface_matches_reference(with_sparse):
    init, loss, sparse = _fns()
    kw = dict(init=init, loss_fn=loss, sparse_grad_fn=sparse if with_sparse else None,
              config="cfg")
    m, j = TrainableModel(**kw), JModel(**kw)
    for key in ("init", "loss_fn", "sparse_grad_fn", "config", "missing", 3):
        assert (key in m) == (key in j), key
        assert m.get(key, "dflt") == j.get(key, "dflt") if isinstance(key, str) else True
        try:
            want = j[key]
        except KeyError:
            with pytest.raises(KeyError):
                m[key]
        else:
            assert m[key] is want
