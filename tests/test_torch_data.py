"""The port's copies of the host data path and scheduler give the
reference's arrays exactly for a seed: dataset, split, batch stream,
scheduler plan and the stacked plan grid."""
from __future__ import annotations

import numpy as np
import pytest

from repro.configs.base import ElasticConfig as JElasticConfig
from repro.core.heterogeneity import CostModel as JCostModel
from repro.core.heterogeneity import SpeedModel as JSpeedModel
from repro.core.scheduler import DynamicScheduler as JScheduler
from repro.data.providers import SparseProvider as JProvider
from repro.data.sparse import train_test_split as jax_split
from repro.data.xml_synth import make_xml_dataset as jax_make_dataset
from repro_torch.configs.base import ElasticConfig
from repro_torch.core.heterogeneity import CostModel, SpeedModel
from repro_torch.core.scheduler import DynamicScheduler
from repro_torch.data.providers import SparseProvider
from repro_torch.data.sparse import train_test_split
from repro_torch.data.xml_synth import make_xml_dataset

CSR = ("indptr", "indices", "values", "label_ptr", "labels")
KW = dict(n_samples=300, n_features=400, n_classes=50, avg_nnz=20)


def _assert_same_dataset(a, b):
    assert (a.n_features, a.n_classes) == (b.n_features, b.n_classes)
    for f in CSR:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("seed", [0, 3])
def test_dataset_and_split_identical(seed):
    ds, jds = make_xml_dataset(seed=seed, **KW), jax_make_dataset(seed=seed, **KW)
    _assert_same_dataset(ds, jds)
    for a, b in zip(train_test_split(ds, 0.2, seed=seed), jax_split(jds, 0.2, seed=seed)):
        _assert_same_dataset(a, b)


def _planned_grids(seed, R=4, b_max=16, mega_batch=9, n_mb=3):
    """Plan a few mega-batches with each package's scheduler and provider;
    returns, for the port and then the reference, one (plan, stacked
    arrays, mask, clock times) tuple per mega-batch."""
    out = []
    for cfg_cls, speed_cls, cost_cls, sched_cls, prov_cls, make in (
        (ElasticConfig, SpeedModel, CostModel, DynamicScheduler, SparseProvider,
         make_xml_dataset),
        (JElasticConfig, JSpeedModel, JCostModel, JScheduler, JProvider,
         jax_make_dataset),
    ):
        cfg = cfg_cls.from_bmax(b_max, n_replicas=R, mega_batch=mega_batch)
        sched = sched_cls(cfg, cost_cls(speed_cls(R, seed=seed)))
        prov = prov_cls.make(make(seed=seed, **KW), seed=seed)
        b = np.array([16, 12, 9, 16])
        runs = []
        for _ in range(n_mb):
            def fetch(i, take, prov=prov):
                p = prov.fetch(take, b_max)
                return p, prov.work_units(p)

            plan = sched.plan_megabatch(b, cfg.mega_batch * b_max, fetch_fn=fetch)
            stacked, mask = prov.stack_plan(plan.payload_grid(R), b_max)
            runs.append((plan, stacked, mask, sched.clock.t.copy()))
        out.append(runs)
    return out


def test_scheduler_plan_and_stacked_grid_identical():
    port_runs, ref_runs = _planned_grids(seed=1)
    for (plan, stacked, mask, clock), (jplan, jstacked, jmask, jclock) in zip(port_runs, ref_runs):
        np.testing.assert_array_equal(plan.u, jplan.u)
        assert plan.n_rounds == jplan.n_rounds
        assert plan.barrier_time == jplan.barrier_time
        np.testing.assert_array_equal(clock, jclock)
        np.testing.assert_array_equal(mask, jmask)
        assert set(stacked) == set(jstacked)
        for k in stacked:
            assert stacked[k].dtype == jstacked[k].dtype, k
            np.testing.assert_array_equal(stacked[k], jstacked[k], err_msg=k)


def test_batch_stream_and_test_batches_identical():
    ds = make_xml_dataset(seed=2, **KW)
    prov = SparseProvider.make(ds, seed=4)
    jprov = JProvider.make(jax_make_dataset(seed=2, **KW), seed=4)
    assert (prov.batcher.max_nnz, prov.batcher.max_labels) == (
        jprov.batcher.max_nnz, jprov.batcher.max_labels)
    for take in (16, 7, 300, 16):  # 300 wraps the epoch: reshuffle
        a, b = prov.fetch(take, 300), jprov.fetch(take, 300)
        for f in ("feat_idx", "feat_val", "feat_mask", "label_idx", "label_mask", "sample_mask"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    for a, b in zip(prov.test_batches(ds, 32, max_samples=100),
                    jprov.test_batches(ds, 32, max_samples=100)):
        np.testing.assert_array_equal(a.feat_idx, b.feat_idx)
        np.testing.assert_array_equal(a.sample_mask, b.sample_mask)
