"""Crash-consistent checkpoints in the port (``repro_torch.checkpoint.store``
and ``ElasticTrainer.checkpoint_payload``/``restore_checkpoint``), in the
reference's on-disk format.

* the store: round trip of nested trees (bf16 as its ``uint16`` bits under
  ``"bfloat16"``, crossing to and from the reference's store), atomic
  publish (a crash mid-write publishes nothing, mid-overwrite keeps the
  old checkpoint), a missing or corrupt checkpoint or key raising
  ``CheckpointError``, ``latest_checkpoint`` skipping incomplete and
  staging directories;
* the manager: interval, retention, a background failure surfacing, and a
  snapshot that stays as it was while training goes on in place on the
  CPU;
* restores: a port checkpoint restores into the port and continues the
  uninterrupted run exactly, for every algorithm; a reference checkpoint
  restores into the port, and a port checkpoint into the reference, each
  continuing the writer's trajectory (host decisions and fleet log
  identical, losses and model within 1e-5) — the XML model under the
  elastic scenario of ``tests/torch_elastic_runs.py``, and reduced
  tinyllama in f32 (``tests/torch_lm_runs.py``);
* a CPU launcher SIGKILLed after its first published checkpoint resumes
  from it and continues the uninterrupted trajectory;
* with a mega-batch staged, the checkpoint holds the cursors from before
  its plan: the reference's, its ``meta.json`` byte for byte a sequential
  run's (the snapshot's order array written as the ``state_dict`` list),
  and it restores across the packages.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_elastic_runs as E
import torch_lm_runs as L
from torch_lm_runs import one_thread  # noqa: F401 (a fixture)
from repro.checkpoint import store as jstore
from repro.core.trainer import ElasticTrainer as JTrainer
from repro.data.providers import TokenProvider as JProvider
from repro.models import model as JMDL
from repro_torch.checkpoint import store
from repro_torch.core import algorithms
from repro_torch.core.trainer import ElasticTrainer
from repro_torch.data.providers import TokenProvider
from repro_torch.models import model as MDL
from repro_torch.models.protocol import TrainableModel
from repro_torch.utils import tree as tu

# small ops on a CPU shared by several test workers: one torch thread
# (tests/torch_lm_runs.py)
pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "replicas": {"w": torch.randn(3, 4, generator=g),
                     "blocks": {"pos0": {"wq": torch.randn(2, 2, generator=g)}},
                     "prefix": [{"wi": torch.randn(5, generator=g).to(torch.bfloat16)}]},
        "momentum": None,
        "b": np.array([1.5, 2.5]),
        "speed": {"factors": np.array([1.0, 1.3])},
    }


def _assert_trees_equal(a, b):
    pa, pb = dict(store._leaf_paths(a)), dict(store._leaf_paths(b))
    assert sorted(pa) == sorted(pb)
    for k in pa:
        x, y = pa[k], pb[k]
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype and torch.equal(x, y), k
        else:
            np.testing.assert_array_equal(x, y, err_msg=k)


def test_roundtrip_nested_tree_in_the_reference_layout(tmp_path):
    path = str(tmp_path / "c")
    tree = _tree()
    store.save(path, tree, metadata={"megabatch_idx": 3})
    restored, meta = store.load(path, tree)
    _assert_trees_equal(restored, tree)
    assert meta["megabatch_idx"] == 3
    assert meta["_keys"] == ["b", "replicas/blocks/pos0/wq", "replicas/prefix/0/wi",
                             "replicas/w", "speed/factors"]
    assert meta["_dtypes"] == {"replicas/prefix/0/wi": "bfloat16"}
    with np.load(os.path.join(path, "tensors.npz")) as data:
        bits = data["replicas/prefix/0/wi"]
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(
        bits, tree["replicas"]["prefix"][0]["wi"].view(torch.int16).numpy().view(np.uint16))
    with pytest.raises(ValueError, match="shape mismatch"):
        store.load(path, dict(tree, b=np.zeros(3)))


def test_bf16_and_f32_cross_the_two_stores(tmp_path):
    """bf16 goes through its bits both ways, never through f32."""
    x = torch.randn(7, 3, generator=torch.Generator().manual_seed(1))
    tree = {"g": {"w": x.to(torch.bfloat16), "v": x}}
    store.save(str(tmp_path / "port"), tree)
    jlike = {"g": {"w": jnp.zeros((7, 3), jnp.bfloat16), "v": jnp.zeros((7, 3), jnp.float32)}}
    jtree, _ = jstore.load(str(tmp_path / "port"), jlike)
    assert jtree["g"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(jtree["g"]["w"]).view(np.uint16),
                                  tree["g"]["w"].view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(jtree["g"]["v"], x.numpy())

    jstore.save(str(tmp_path / "ref"), jtree)
    back, _ = store.load(str(tmp_path / "ref"), tree)
    _assert_trees_equal(back, tree)


def test_crash_mid_write_leaves_no_partial_checkpoint(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("disk died")

    monkeypatch.setattr(store.np, "savez", boom)
    with pytest.raises(RuntimeError, match="disk died"):
        store.save(str(tmp_path / "c"), {"w": torch.zeros(3)})
    assert list(tmp_path.iterdir()) == []   # nothing published, staging dir gone


def test_crash_mid_overwrite_keeps_old_checkpoint(tmp_path, monkeypatch):
    path = str(tmp_path / "c")
    store.save(path, {"w": torch.zeros(3)}, metadata={"v": 1})
    real = store.np.savez
    monkeypatch.setattr(store.np, "savez",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("torn")))
    with pytest.raises(RuntimeError):
        store.save(path, {"w": torch.ones(3)}, metadata={"v": 2})
    monkeypatch.setattr(store.np, "savez", real)
    restored, meta = store.load(path, {"w": torch.zeros(3)})
    assert meta["v"] == 1 and torch.equal(restored["w"], torch.zeros(3))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["c"]


def test_missing_or_corrupt_checkpoint_raises_checkpoint_error(tmp_path):
    with pytest.raises(store.CheckpointError, match="no checkpoint"):
        store.load(str(tmp_path / "nope"), {"w": torch.zeros(2)})
    path = str(tmp_path / "c")
    store.save(path, {"w": torch.zeros(2)})
    with pytest.raises(store.CheckpointError, match="extra"):
        store.load(path, {"w": torch.zeros(2), "extra": torch.zeros(1)})
    with open(os.path.join(path, "meta.json"), "a") as f:
        f.write("{torn")
    with pytest.raises(store.CheckpointError, match="metadata is corrupt"):
        store.load(path, {"w": torch.zeros(2)})
    store.save(path, {"w": torch.zeros(2)})
    with open(os.path.join(path, "tensors.npz"), "wb") as f:
        f.write(b"torn write, not a zip")
    with pytest.raises(store.CheckpointError, match="corrupt"):
        store.load(path, {"w": torch.zeros(2)})
    os.remove(os.path.join(path, "tensors.npz"))
    with pytest.raises(store.CheckpointError, match="no tensors.npz"):
        store.load(path, {"w": torch.zeros(2)})


def test_latest_checkpoint_ignores_incomplete_and_staging(tmp_path):
    store.save(str(tmp_path / "ckpt-000002"), {"w": torch.zeros(1)})
    store.save(str(tmp_path / "ckpt-000004"), {"w": torch.zeros(1)})
    os.makedirs(tmp_path / "ckpt-000006")            # no meta.json: torn
    os.makedirs(tmp_path / ".tmp-ckpt-000008-x")
    assert store.latest_checkpoint(str(tmp_path)).endswith("ckpt-000004")
    assert store.resolve_checkpoint(str(tmp_path)).endswith("ckpt-000004")
    assert store.checkpoint_index("ckpt-000004") == 4 and store.checkpoint_index("x") is None
    assert store.latest_checkpoint(str(tmp_path / "missing")) is None
    with pytest.raises(store.CheckpointError):
        store.resolve_checkpoint(str(tmp_path / "empty"))


# --------------------------------------------------------------------------
# the manager
# --------------------------------------------------------------------------


class _FakeTrainer:
    def checkpoint_payload(self, state):
        return {"x": state.x}, {"megabatch_idx": state.megabatch_idx}


@dataclasses.dataclass
class _FakeState:
    x: torch.Tensor
    megabatch_idx: int


def test_manager_interval_retention_and_timings(tmp_path):
    mgr = store.CheckpointManager(str(tmp_path), every=2, retain=2)
    for idx in range(0, 9):
        mgr.maybe_save(_FakeTrainer(), _FakeState(torch.full((3,), float(idx)), idx))
    mgr.wait()
    names = sorted(n for n in os.listdir(tmp_path) if n.startswith(store.CKPT_PREFIX))
    assert names == ["ckpt-000006", "ckpt-000008"]   # 2 and 4 swept, 0 never saved
    assert mgr.latest().endswith("ckpt-000008")
    assert [t["megabatch"] for t in mgr.timings] == [2, 4, 6, 8]
    assert all(t["bytes"] == 12 and t["write_s"] is not None for t in mgr.timings)
    assert mgr.maybe_save(_FakeTrainer(), _FakeState(torch.zeros(3), 8)) is None   # done


def test_manager_background_failure_surfaces(tmp_path, monkeypatch):
    mgr = store.CheckpointManager(str(tmp_path), every=1)
    monkeypatch.setattr(store, "save",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("writer died")))
    mgr.maybe_save(_FakeTrainer(), _FakeState(torch.zeros(3), 1))
    with pytest.raises(store.CheckpointError, match="writer died"):
        mgr.wait()
    with pytest.raises(ValueError):
        store.CheckpointManager(str(tmp_path), every=0)
    with pytest.raises(ValueError):
        store.CheckpointManager(str(tmp_path), retain=0)


def test_snapshot_stays_as_it_was_while_training_goes_on(tmp_path, monkeypatch):
    """On the CPU a tensor's ``.cpu()`` is the tensor itself and
    ``.numpy()`` shares its memory: the snapshot must be a copy, or the
    background write sees the next mega-batch's in-place updates. The
    write is held until the trainer has run on."""
    tr, _ = E.port_trainer("adaptive", momentum=0.9)
    state, _ = tr.run_megabatch(tr.init_state())
    state, _ = tr.run_megabatch(state)
    want = {k: v.clone() for k, v in state.replicas.items()}
    release, real = threading.Event(), store.save

    def held(*a, **k):
        release.wait(60)
        return real(*a, **k)

    monkeypatch.setattr(store, "save", held)
    mgr = store.CheckpointManager(str(tmp_path), every=1)
    mgr.maybe_save(tr, state)
    state, _ = tr.run_megabatch(state)           # updates the replicas in place
    assert not all(torch.equal(state.replicas[k], want[k]) for k in want)
    release.set()
    mgr.wait()
    got, meta = store.load(mgr.latest(), {"replicas": want})
    assert meta["megabatch_idx"] == 2
    _assert_trees_equal(got, {"replicas": want})


# --------------------------------------------------------------------------
# restores
# --------------------------------------------------------------------------


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in ("wall_clock", "wall_s")}


@pytest.mark.parametrize("algo", algorithms.available())
def test_restore_continues_the_uninterrupted_run_exactly(tmp_path, algo):
    """Checkpoints every mega-batch under the elastic scenario; a fresh
    trainer built at another width restores the one after mega-batch 6 (no
    fleet state is pending there: the controller is not part of a
    checkpoint, in either package) and finishes the run bit for bit."""
    kw = dict(n_mb=8, faults=E.FAULTS if algo != "single" else None)
    mgr = store.CheckpointManager(str(tmp_path), every=1, retain=8)
    s_full, m_full, ev_full = E.run_port(algo, checkpoint=mgr, **kw)
    tr, test = E.port_trainer(algo, n_replicas=2)
    s_res, m_res, ev_res = E.run_port(algo, trainer=(tr, test),
                                      restore_from=mgr.step_path(6), **kw)
    assert [_strip(r) for r in m_res.records] == [_strip(r) for r in m_full.records[6:]]
    assert ev_res == [e for e in ev_full if e["mb"] >= 6]
    for k in s_full.replicas:
        assert torch.equal(s_res.replicas[k], s_full.replicas[k])
        assert torch.equal(s_res.global_model[k], s_full.global_model[k])


def test_restore_refuses_a_mismatched_trainer(tmp_path):
    tr, _ = E.port_trainer("adaptive")
    state, _ = tr.run_megabatch(tr.init_state())
    mgr = store.CheckpointManager(str(tmp_path), every=1)
    mgr.maybe_save(tr, state)
    mgr.wait()
    other, _ = E.port_trainer("elastic")
    with pytest.raises(store.CheckpointError, match="algorithm"):
        other.restore_checkpoint(str(tmp_path))
    with_momentum, _ = E.port_trainer("adaptive", momentum=0.9)
    with pytest.raises(store.CheckpointError, match="momentum"):
        mgr.restore(with_momentum)
    with pytest.raises(store.CheckpointError, match="no checkpoint"):
        store.CheckpointManager(str(tmp_path / "empty")).restore(tr)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_xml_checkpoint_crosses_packages(tmp_path, writer):
    """The writer runs the elastic scenario with a checkpoint every
    mega-batch; the other package restores the one after mega-batch 6 and
    continues as the writer did."""
    kw = dict(n_mb=9)
    if writer == "reference":
        mgr = jstore.CheckpointManager(str(tmp_path), every=1, retain=9)
        full = E.run_ref("adaptive", checkpoint=mgr, **kw)
        resumed = E.run_port("adaptive", restore_from=mgr.step_path(6), **kw)
        port_state, ref_state = resumed[0], full[0]
    else:
        mgr = store.CheckpointManager(str(tmp_path), every=1, retain=9)
        full = E.run_port("adaptive", checkpoint=mgr, **kw)
        resumed = E.run_ref("adaptive", restore_from=mgr.step_path(6), **kw)
        port_state, ref_state = full[0], resumed[0]
    (_, w_log, w_events), (_, r_log, r_events) = full, resumed
    assert [r["megabatch"] for r in r_log.records] == [7, 8, 9]
    assert r_events == [e for e in w_events if e["mb"] >= 6]
    assert any(e["action"] == "join" for e in r_events)   # a resize after the restore
    for rec, wrec in zip(r_log.records, w_log.records[6:]):
        for k in E.EXACT + ("megabatch",):
            assert rec[k] == wrec[k], (rec["megabatch"], k)
        for k in E.METRICS:
            np.testing.assert_allclose(rec[k], wrec[k], err_msg=k, **E.TOL)
    E.assert_state_matches(port_state, ref_state)


def test_restore_with_a_fresh_controller_matches_the_reference(tmp_path):
    """No checkpoint holds fleet state, in either package (ROADMAP Queue 3):
    restored after mega-batch 4 with a fresh controller, a run loses the
    crash's pending readmission and the stall's end. The port's restored
    run equals the reference's restored run from the same checkpoint, and
    both leave the uninterrupted trajectory the same way."""
    mgr = jstore.CheckpointManager(str(tmp_path), every=1, retain=8)
    _, full_log, _ = E.run_ref("adaptive", checkpoint=mgr)
    port_run = E.run_port("adaptive", restore_from=mgr.step_path(4))
    E.assert_runs_match(port_run, E.run_ref("adaptive", restore_from=mgr.step_path(4)), 3)
    assert [r["n_replicas"] for r in full_log.records[4:]] == [4, 5, 6]
    assert [r["n_replicas"] for r in port_run[1].records] == [4, 4, 5]
    assert [(e["mb"], e["action"]) for e in port_run[2]] == [
        (4, "evict"), (5, "rejoin"), (6, "join")]


def _lm_port_trainer():
    _, tcfg = L.configs("tinyllama-1.1b")
    p0 = L.init_np("tinyllama-1.1b")
    model = TrainableModel(init=lambda generator: tu.flatten(MDL.params_from_jax(p0, "cpu")),
                           loss_fn=MDL.make_model(tcfg).loss_fn, config=tcfg)
    prov = TokenProvider.make(tcfg.vocab_size, L.SEQ, seed=0)
    test = prov.test_batches(2, L.B_MAX)
    return ElasticTrainer(model, prov, L._elastic(L.ElasticConfig, "adaptive"), base_lr=L.LR,
                          seed=0, device="cpu"), test


def _lm_ref_trainer():
    jcfg, _ = L.configs("tinyllama-1.1b")
    prov = JProvider.make(jcfg.vocab_size, L.SEQ, seed=0)
    test = prov.test_batches(2, L.B_MAX)
    return JTrainer(JMDL.make_model(jcfg), prov, L._elastic(L.JElasticConfig, "adaptive"),
                    base_lr=L.LR, seed=0), test


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_lm_checkpoint_crosses_packages(tmp_path, writer):
    """Reduced tinyllama in f32, Adaptive SGD, R = 4: the LM's nested
    parameter tree is stored under the same ``/``-joined paths by both
    packages. The other package restores the checkpoint after mega-batch 1
    and continues as the writer did, within the f32 LM tolerance of
    ``tests/torch_lm_runs.py``."""
    n = L.N_MB
    if writer == "reference":
        tr, test = _lm_ref_trainer()
        mgr = jstore.CheckpointManager(str(tmp_path), every=1, retain=n)
        w_state, w_log = tr.run(n, test_batches=test, checkpoint=mgr)
        tr, test = _lm_port_trainer()
    else:
        tr, test = _lm_port_trainer()
        mgr = store.CheckpointManager(str(tmp_path), every=1, retain=n)
        w_state, w_log = tr.run(n, test_batches=test, checkpoint=mgr)
        tr, test = _lm_ref_trainer()
    port_keys = _lm_port_trainer()[0].init_state().replicas
    stored = store.load_metadata(mgr.step_path(1))["_keys"]
    assert {f"replicas/{k.replace('.', '/')}" for k in port_keys} == {
        k for k in stored if k.startswith("replicas/")}
    r_state, r_log = tr.run(n, test_batches=test, restore_from=mgr.step_path(1))
    assert [r["megabatch"] for r in r_log.records] == list(range(2, n + 1))
    for rec, wrec in zip(r_log.records, w_log.records[1:]):
        for k in L.EXACT:
            assert rec[k] == wrec[k], (rec["megabatch"], k)
        for k in L.METRICS:
            np.testing.assert_allclose(rec[k], wrec[k], err_msg=k, **L.F32_TOL)
    flat = lambda t: {k: np.asarray(v, np.float64) for k, v in tu.flatten(  # noqa: E731
        jax.tree_util.tree_map(lambda x: x.numpy() if isinstance(x, torch.Tensor) else x,
                               t)).items()}
    got, want = flat(r_state.global_model), flat(w_state.global_model)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **L.F32_TOL)


# --------------------------------------------------------------------------
# SIGKILL and restore, through the launcher
# --------------------------------------------------------------------------

MEGABATCHES, EVERY = 40, 2


def _launcher(*extra):
    return [sys.executable, "-u", "-m", "repro_torch.launch.train", "--workload", "xml",
            "--device", "cpu", "--samples", "1024", "--features", "256", "--classes", "64",
            "--hidden", "32", "--b-max", "32", "--mega-batch", "6", "--replicas", "3",
            "--megabatches", str(MEGABATCHES), "--seed", "0", *extra]


def _complete(ckpt_dir) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(store.checkpoint_index(n) for n in os.listdir(ckpt_dir)
                  if store.checkpoint_index(n) is not None
                  and os.path.exists(os.path.join(ckpt_dir, n, "meta.json")))


def test_sigkill_and_restore_continue_the_uninterrupted_run(tmp_path):
    """Each subprocess and the wait for the first checkpoint have their
    own time limit (about 5 s of work in all on one CPU thread)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    ckpt = str(tmp_path / "ckpt")
    flags = ["--checkpoint-dir", ckpt, "--checkpoint-every", str(EVERY)]
    ref = subprocess.run(_launcher("--out", str(tmp_path / "ref.json")), env=env,
                         capture_output=True, text=True, timeout=60)
    assert ref.returncode == 0, ref.stderr[-3000:]

    victim = subprocess.Popen(_launcher(*flags), env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + 60
    while not _complete(ckpt):
        if victim.poll() is not None:
            pytest.fail(f"the launcher exited before a checkpoint:\n{victim.stderr.read()[-3000:]}")
        if time.monotonic() > deadline:
            victim.kill()
            pytest.fail("no checkpoint published within 60 s")
        time.sleep(0.02)
    victim.send_signal(signal.SIGKILL)
    victim.communicate(timeout=30)
    assert victim.returncode == -signal.SIGKILL
    latest = _complete(ckpt)[-1]
    assert 1 <= latest < MEGABATCHES

    resumed = subprocess.run(_launcher(*flags, "--restore-from", ckpt, "--out",
                                       str(tmp_path / "res.json")),
                             env=env, capture_output=True, text=True, timeout=60)
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    with open(tmp_path / "ref.json") as f:
        full = json.load(f)
    with open(tmp_path / "res.json") as f:
        res = json.load(f)
    assert [r["megabatch"] for r in res] == list(range(latest + 1, MEGABATCHES + 1))
    for rec, want in zip(res, full[latest:]):
        for k in E.EXACT:
            assert rec[k] == want[k], (rec["megabatch"], k)
        for k in E.METRICS:
            np.testing.assert_allclose(rec[k], want[k], err_msg=k, **E.TOL)


# --------------------------------------------------------------------------
# checkpoints taken while the overlap pipeline has a mega-batch staged
# --------------------------------------------------------------------------


def test_checkpoint_mid_prefetch_stores_the_snapshot_cursors():
    """With mega-batch 2 staged, the payload holds the cursors from before
    its plan: those of a sequential run at the same point, and of the
    reference's payload at the same point of its own pipelined run."""
    tr, _ = E.port_trainer("adaptive")
    oracle, _ = E.port_trainer("adaptive")
    oracle.overlap = False
    jtr, _ = E.ref_trainer("adaptive")
    state, _ = tr.run_megabatch(tr.init_state(), prefetch=True)
    o_state, _ = oracle.run_megabatch(oracle.init_state())
    j_state, _ = jtr.run_megabatch(jtr.init_state(), prefetch=True)
    assert tr._staged is not None
    assert tr.provider.state_dict() != oracle.provider.state_dict()   # staging moved on
    tree, meta = tr.checkpoint_payload(state)
    for other_tree, other_meta in (oracle.checkpoint_payload(o_state),
                                   jtr.checkpoint_payload(j_state)):
        assert meta["provider"] == other_meta["provider"]
        assert repr(meta["speed_meta"]) == repr(other_meta["speed_meta"])
        np.testing.assert_array_equal(tree["clock_t"], other_tree["clock_t"])
        for k in tree["speed"]:
            np.testing.assert_array_equal(tree["speed"][k], np.asarray(other_tree["speed"][k]))


def test_mid_prefetch_checkpoint_writes_the_snapshot_order_as_a_list(tmp_path):
    """With mega-batch 2 staged, the snapshot's order array is written as
    the ``state_dict`` list of Python ints: the metadata is the reference's
    stream ``state_dict`` at the same cursor, ``meta.json`` is byte for byte
    the one a sequential run writes at the same point, and a fresh trainer
    restoring it finishes the writer's run bit for bit."""
    tr, _ = E.port_trainer("adaptive")
    oracle, _ = E.port_trainer("adaptive")
    oracle.overlap = False
    jtr, _ = E.ref_trainer("adaptive")
    state, o_state, j_state = tr.init_state(), oracle.init_state(), jtr.init_state()
    for _ in range(2):
        state, _ = tr.run_megabatch(state, prefetch=True)
        o_state, _ = oracle.run_megabatch(o_state)
        j_state, _ = jtr.run_megabatch(j_state, prefetch=True)
    order = tr._staged.snapshot["provider"]["stream"]["order"]
    assert type(order) is np.ndarray
    paths = {}
    for name, t, s in (("prefetch", tr, state), ("sequential", oracle, o_state)):
        mgr = store.CheckpointManager(str(tmp_path / name), every=1)
        mgr.maybe_save(t, s)
        mgr.wait()
        paths[name] = mgr.step_path(2)
    meta = store.load_metadata(paths["prefetch"])["provider"]
    listed = meta["stream"]["order"]
    assert type(listed) is list and all(type(i) is int for i in listed)
    assert listed == order.tolist()
    jtr.invalidate_prefetch()                      # the reference's cursor before its plan
    assert meta == jtr.provider.state_dict()
    with open(os.path.join(paths["prefetch"], "meta.json"), "rb") as f:
        written = f.read()
    with open(os.path.join(paths["sequential"], "meta.json"), "rb") as f:
        assert written == f.read()
    fresh, _ = E.port_trainer("adaptive")
    r_state = fresh.restore_checkpoint(paths["prefetch"])
    for prefetch in (True, False):
        state, info = tr.run_megabatch(state, prefetch=prefetch)
        r_state, r_info = fresh.run_megabatch(r_state, prefetch=prefetch)
        assert _strip(r_info) == _strip(info)
    for k in state.replicas:
        assert torch.equal(r_state.replicas[k], state.replicas[k])
        assert torch.equal(r_state.global_model[k], state.global_model[k])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_mid_prefetch_checkpoint_crosses_packages(tmp_path, writer):
    """The writer runs two pipelined mega-batches, so the third is staged,
    and saves a checkpoint; the other package restores it and replays the
    staged mega-batch and one more with the writer's host decisions (the
    writer consumes its staged plan), losses and model within 1e-5."""
    port_tr, _ = E.port_trainer("adaptive")
    ref_tr, _ = E.ref_trainer("adaptive")
    w_tr, r_tr, w_store = ((ref_tr, port_tr, jstore) if writer == "reference"
                           else (port_tr, ref_tr, store))
    state = w_tr.init_state()
    for _ in range(2):
        state, _ = w_tr.run_megabatch(state, prefetch=True)
    assert w_tr._staged is not None
    mgr = w_store.CheckpointManager(str(tmp_path), every=1)
    mgr.maybe_save(w_tr, state)
    mgr.wait()
    path = mgr.step_path(2)
    assert store.load_metadata(path)["provider"] != w_tr.provider.state_dict()
    r_state = r_tr.restore_checkpoint(path)
    infos = {}
    for name, tr, s in (("writer", w_tr, state), ("reader", r_tr, r_state)):
        recs = []
        for prefetch in (True, False):
            s, info = tr.run_megabatch(s, prefetch=prefetch)
            recs.append(info)
        infos[name] = (s, recs)
    (w_state, w_recs), (r_state, r_recs) = infos["writer"], infos["reader"]
    for rec, wrec in zip(r_recs, w_recs):
        for k in E.EXACT:
            assert rec[k] == wrec[k], k
        for k in ("train_loss", "train_accuracy"):
            np.testing.assert_allclose(rec[k], wrec[k], err_msg=k, **E.TOL)
    port_state, ref_state = (r_state, w_state) if writer == "reference" else (w_state, r_state)
    E.assert_state_matches(port_state, ref_state)
