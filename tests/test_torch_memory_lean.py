"""``keep_global_copies=False`` in the port: the paper's §4 memory-lean
merging, held to live reference runs with the same setting.

``adaptive`` and ``elastic`` keep Algorithm 2's global and prev-global
copies by default; with the option off they start without them, merge
with ``gamma`` 0 (the weighted-merge op's no-momentum branch) until their
barriers have produced both, and from then on as before, in both packages.
``sync`` and ``crossbow`` keep no copies, so the option leaves them bitwise
unchanged.

* ``init_state``: no copies, the same initial b and lr;
* runs of ``adaptive`` and ``elastic`` through the pipeline (``scan``)
  and the sequential path (``sequential``) on both gradient paths: host
  decisions exact, losses and the global model within rtol
  1e-5 / atol 1e-6 (``tests/torch_elastic_runs.py``), and the merges
  counted at the op, with and without the momentum term;
* the resize schedule and every fault kind of ``tests/torch_elastic_runs.
  py`` with the option off (resizes, an eviction and the guard's donor
  merge), and a fully diverged population before the first barrier, which
  both packages refuse (no global to restart from);
* checkpoints with the copies off (none, then a global without its
  prev-global) crossing the packages both ways.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_elastic_runs as E
from torch_lm_runs import one_thread  # noqa: F401 (a fixture)
from repro.checkpoint import store as jstore
from repro_torch.checkpoint import store
from repro_torch.kernels.weighted_merge import ops as merge_ops

# small ops on a CPU shared by several test workers: one torch thread
# (tests/torch_lm_runs.py)
pytestmark = pytest.mark.usefixtures("one_thread")

N_MB = 4
LEAN = dict(keep_global_copies=False)


@pytest.fixture
def merge_branches(monkeypatch):
    """Counts the weighted-merge op's calls by branch: with the momentum
    term (``g`` given) and without."""
    calls = {"momentum": 0, "plain": 0}
    real = merge_ops.merge

    def counted(replicas, alphas, g=None, gp=None, gamma=0.0):
        calls["momentum" if g is not None and gamma != 0.0 else "plain"] += 1
        return real(replicas, alphas, g, gp, gamma)

    monkeypatch.setattr(merge_ops, "merge", counted)
    return calls


@pytest.mark.parametrize("algo", ["adaptive", "elastic"])
def test_init_state_keeps_no_copies(algo):
    kept, _ = E.port_trainer(algo)
    lean, _ = E.port_trainer(algo, **LEAN)
    jlean, _ = E.ref_trainer(algo, **LEAN)
    s_kept, s_lean, j_lean = kept.init_state(), lean.init_state(), jlean.init_state()
    assert s_kept.global_model is not None and s_kept.prev_global is not None
    assert s_lean.global_model is None and s_lean.prev_global is None
    assert j_lean.global_model is None and j_lean.prev_global is None
    for s in (s_kept, j_lean):
        np.testing.assert_array_equal(s_lean.b, np.asarray(s.b))
        np.testing.assert_array_equal(s_lean.lr, np.asarray(s.lr))


CASES = [(a, p, sp) for a in ("adaptive", "elastic") for p in ("scan", "sequential")
         for sp in (True, False)]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-{'sparse' if c[2] else 'dense'}")
def test_memory_lean_run_matches_reference(case, merge_branches):
    """The first two barriers merge without the momentum term (no global,
    then no prev-global), the rest with it: one op call a leaf each."""
    algo, path, sparse = case
    kw = dict(overlap=path == "scan")
    tr, test = E.port_trainer(algo, sparse, **kw, **LEAN)
    port_run = E.run_port(algo, n_mb=N_MB, schedule=None, faults=None, trainer=(tr, test))
    jtr, jtest = E.ref_trainer(algo, sparse, **kw, **LEAN)
    ref_run = E.run_ref(algo, n_mb=N_MB, schedule=None, faults=None, trainer=(jtr, jtest))
    E.assert_runs_match(port_run, ref_run, n_mb=N_MB)
    n_leaves = len(port_run[0].global_model)
    assert merge_branches == {"plain": 2 * n_leaves, "momentum": (N_MB - 2) * n_leaves}
    # and the run differs from the one that keeps the copies from the start
    kept, ktest = E.port_trainer(algo, sparse, **kw)
    k_state, _, _ = E.run_port(algo, n_mb=N_MB, schedule=None, faults=None,
                               trainer=(kept, ktest))
    assert not torch.equal(k_state.global_model["w1"], port_run[0].global_model["w1"])


@pytest.mark.parametrize("algo", ["sync", "crossbow"])
def test_option_leaves_algorithms_without_copies_bitwise_unchanged(algo):
    """The elastic scenario (resizes and every fault kind), the option on
    and off: records, fleet log and state identical bit for bit."""
    runs = [E.run_port(algo, trainer=E.port_trainer(algo, **kw)) for kw in ({}, LEAN)]
    (s_a, m_a, ev_a), (s_b, m_b, ev_b) = runs
    strip = [[{k: v for k, v in r.items() if k not in ("wall_clock", "wall_s")}
              for r in m.records] for m in (m_a, m_b)]
    np.testing.assert_equal(strip[0], strip[1])    # NaN losses (the guard) compare equal
    assert ev_a == ev_b
    for name in ("replicas", "global_model"):
        for k, v in getattr(s_a, name).items():
            assert torch.equal(v, getattr(s_b, name)[k]), (name, k)


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap_on", "overlap_off"])
def test_elastic_scenario_without_copies_matches_reference(overlap):
    """Resizes 4 -> 6 -> 3, a NaN healed by the guard's donor merge, a
    crash (an eviction), a stall, a preemption, the readmissions and a
    join, with the copies off from the start."""
    tr, test = E.port_trainer("adaptive", **LEAN)
    jtr, jtest = E.ref_trainer("adaptive", **LEAN)
    tr.overlap = jtr.overlap = overlap
    port_run = E.run_port("adaptive", trainer=(tr, test))
    E.assert_runs_match(port_run, E.run_ref("adaptive", trainer=(jtr, jtest)))
    assert any(r.get("guard_repaired") for r in port_run[1].records)


def test_fully_diverged_population_without_a_global_raises_as_the_reference():
    """Every replica poisoned before the first barrier: with the copies
    off there is no global model to restart from, and both packages refuse
    with the same error."""
    faults = ",".join(f"0:nan:{i}" for i in range(E.R0))
    for make, run in ((E.port_trainer, E.run_port), (E.ref_trainer, E.run_ref)):
        with pytest.raises(FloatingPointError, match="no global model to restart from"):
            run("adaptive", n_mb=1, schedule=None, faults=faults, trainer=make("adaptive", **LEAN))


@pytest.mark.parametrize("at", [0, 1], ids=["no_copies", "no_prev_global"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_memory_lean_checkpoint_crosses_packages(tmp_path, writer, at):
    """A checkpoint taken after ``at`` mega-batches with the copies off
    (``has.global_model``/``has.prev_global`` false: none after 0, no
    prev-global after 1) restores into the other package, which continues
    for three mega-batches with the writer's host decisions, losses and
    model (within 1e-5)."""
    w_make, r_make, w_store = ((E.ref_trainer, E.port_trainer, jstore) if writer == "reference"
                               else (E.port_trainer, E.ref_trainer, store))
    w_tr, _ = w_make("adaptive", **LEAN)
    state = w_tr.init_state()
    for _ in range(at):
        state, _ = w_tr.run_megabatch(state)
    path = str(tmp_path / "ckpt")
    w_store.save(path, *w_tr.checkpoint_payload(state))
    has = store.load_metadata(path)["has"]
    assert has == {"momentum": False, "global_model": at >= 1, "prev_global": False}
    r_tr, _ = r_make("adaptive", **LEAN)
    r_state = r_tr.restore_checkpoint(path)
    assert (r_state.global_model is None) == (at == 0) and r_state.prev_global is None
    recs = {}
    for name, tr, s in (("writer", w_tr, state), ("reader", r_tr, r_state)):
        out = []
        for _ in range(3):
            s, info = tr.run_megabatch(s)
            out.append(info)
        recs[name] = (s, out)
    (w_state, w_recs), (r_state, r_recs) = recs["writer"], recs["reader"]
    for rec, wrec in zip(r_recs, w_recs):
        for k in E.EXACT:
            assert rec[k] == wrec[k], k
        for k in ("train_loss", "train_accuracy"):
            np.testing.assert_allclose(rec[k], wrec[k], err_msg=k, **E.TOL)
    port_state, ref_state = (r_state, w_state) if writer == "reference" else (w_state, r_state)
    E.assert_state_matches(port_state, ref_state)
