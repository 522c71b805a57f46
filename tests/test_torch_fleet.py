"""Port parity: the async elastic fleet (``runtime/fleet.py``,
``runtime/elastic.py``, ``launch/fleet.py``, the ``stale-sgd`` rule).

Across packages, both sims on ``gemma-2b.reduced()`` from the JAX
package's initial parameters (a straggler, duplicate deliveries, a
worker that drops a direction, one join, one leave, 12 steps):
  * the schedule is the reference's event for event: every record's
    ``step``, ``seed``, ``staleness`` and ``mask``, the ``applied`` /
    ``reissued`` / ``dropped`` / ``resizes`` counts and ``virtual_s``
    exactly equal;
  * ``gs`` within ``GS_ATOL`` (1e-3) and losses within ``LOSS_ATOL``
    (1e-5), the train CLI's tolerances (``tests/test_torch_train.py``);
  * the final parameters within ``PARAM_ATOL`` = 1e-5: 12 updates of
    lr/K = 5e-4 times a gs gap of at most 1e-3 (6e-6), stated before the
    first run;
  * replay logs cross in both directions: the JAX reader reads the
    port's log, and the port's replay of JAX's log (through
    ``replay_into`` and through the ``AdapterStore``) gives JAX's live
    fleet parameters at atol 0 (Rademacher z, the staleness scale bit
    for bit); JAX's own ``AdapterStore`` ignores ``staleness`` and
    misses them (open in the reference);
  * ``_staleness_coeffs``, ``stale-sgd``, ``lease_latency_s``,
    ``active_params`` / ``model_flops`` (every config) and
    ``mesh_shape_for`` (warnings included) equal the reference's.
Inside the port: the replay of the fleet's own log equals its live
parameters at atol 0, a held lease's snapshot is never written, and a
counterpart of every test of ``tests/test_fleet.py`` and
``tests/test_elastic.py`` (the pipeline's and the straggler policy's are
in ``test_torch_pipeline.py`` and ``test_torch_stragglers.py``).
"""

import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (import order: repro.optim needs it)
from repro.checkpoint import replay_log as j_replay_log  # noqa: E402
from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core.perturb import _path_str  # noqa: E402
from repro.roofline import analysis as j_analysis  # noqa: E402
from repro.runtime import elastic as j_elastic  # noqa: E402
from repro.runtime import fleet as jfleet  # noqa: E402
from repro.serve.adapters import AdapterStore as JAdapterStore  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.checkpoint.replay_log import (ReplayLog,  # noqa: E402
                                               replay_into)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.engine import MezoConfig, SGD, STALE_SGD  # noqa: E402
from repro_torch.launch import fleet as fleet_cli  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.runtime.fleet import (DEVICE_GRADES,  # noqa: E402
                                       FaultSpec, FleetCoordinator, FleetSim,
                                       WorkerSpec, get_grade,
                                       lease_latency_s)
from repro_torch.serve.adapters import AdapterStore  # noqa: E402

torch.set_num_threads(1)

LOSS_ATOL = 1e-5
GS_ATOL = 1e-3
PARAM_ATOL = 1e-5
CFG = get_config("gemma-2b").reduced()
JCFG = j_get_config("gemma-2b").reduced()
MZ_KW = dict(lr=1e-3, n_directions=2, staleness_decay=0.95)
MZ = MezoConfig(**MZ_KW)
JMZ = jengine.MezoConfig(**MZ_KW)


def _flat(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): np.array(v) for p, v in leaves}


def _tensors(flat):
    return store.params_from_numpy(flat, "cpu")


def _max_diff(a, b) -> float:
    return fleet_cli.max_abs_diff(a, b)


def _assert_close(got, want, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=atol, err_msg=k)


def _init(seed=0):
    from repro_torch.models import build_model
    return build_model(CFG).init(torch.Generator().manual_seed(seed), "cpu")


# ---------------------------------------------------------------------------
# across packages: one faulty elastic run in each package


def _workers(mod):
    f, w = mod.FaultSpec, mod.WorkerSpec
    return [w("flagship", f(jitter=0.2, duplicate_every=2)),
            w("flagship", f(jitter=0.2, drop_directions=1)),
            w("flagship", f(jitter=0.2)),
            w("flagship", f(latency_scale=5.0))]          # a straggler


def _step_events(mod):
    return [(4, "join", mod.WorkerSpec("flagship")), (8, "leave", 2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet")
    jsim = jfleet.FleetSim(JCFG, _workers(jfleet), total_steps=12,
                           mezo_cfg=JMZ, batch=2, seq=16, seed=0,
                           log_path=str(root / "jax.jsonl"),
                           step_events=_step_events(jfleet))
    jrep = jsim.run()
    init = _flat(jsim.base_params)
    tsim = FleetSim(CFG, _workers(jfleet), total_steps=12, mezo_cfg=MZ,
                    batch=2, seq=16, seed=0,
                    log_path=str(root / "torch.jsonl"),
                    step_events=_step_events(jfleet),
                    params=_tensors(init), device="cpu")
    trep = tsim.run()
    return dict(init=init, jax_init=jsim.base_params, jrep=jrep,
                jfinal=_flat(jrep.params), tsim=tsim, trep=trep,
                jlog=str(root / "jax.jsonl"), tlog=str(root / "torch.jsonl"))


def test_schedule_matches_jax_event_for_event(runs):
    j, t = runs["jrep"], runs["trep"]
    for key in ("applied", "issued", "reissued", "dropped", "resizes",
                "virtual_s", "staleness"):
        assert getattr(t, key) == getattr(j, key), key
    assert t.applied == 12 and t.resizes == 2 and t.dropped > 0
    assert max(t.staleness) > 0
    assert any("mask" in r for r in t.records)
    for tr, jr in zip(t.records, j.records, strict=True):
        for key in ("step", "seed", "staleness", "lr", "eps"):
            assert tr[key] == jr[key], key
        assert tr.get("mask") == jr.get("mask")
        np.testing.assert_allclose(tr["gs"], jr["gs"], rtol=0, atol=GS_ATOL)
    np.testing.assert_allclose(t.losses, j.losses, rtol=0, atol=LOSS_ATOL)
    _assert_close(t.params, runs["jfinal"], PARAM_ATOL)


def test_own_log_replays_to_live_params_bit_exact(runs):
    tsim, trep = runs["tsim"], runs["trep"]
    recs = ReplayLog.read(runs["tlog"])
    replayed, last = replay_into(tsim.base_params, recs, MZ)
    assert _max_diff(replayed, trep.params) == 0.0
    assert last == trep.records[-1]["step"]
    # theta_0 itself was never written by the coordinator
    _assert_close(tsim.base_params, runs["init"], 0.0)


def test_replay_logs_cross_packages(runs):
    # the port's log, read by the JAX reader
    assert (j_replay_log.ReplayLog.read(runs["tlog"])
            == ReplayLog.read(runs["tlog"]))
    # JAX's log, replayed by the port: JAX's live fleet parameters
    jrecs = ReplayLog.read(runs["jlog"])
    assert jrecs == j_replay_log.ReplayLog.read(runs["jlog"])
    got, _ = replay_into(_tensors(runs["init"]), jrecs, MZ)
    _assert_close(got, runs["jfinal"], 0.0)
    # the port's log, replayed by the JAX package: the port's parameters
    want, _ = j_replay_log.replay_into(
        jax.tree.map(jnp.asarray, runs["jax_init"]),
        j_replay_log.ReplayLog.read(runs["tlog"]), JMZ)
    _assert_close(runs["trep"].params, _flat(want), 0.0)


def test_adapter_store_replays_fleet_log_to_fleet_params(runs):
    """The port's AdapterStore replays a fleet log through the stale-sgd
    coefficients: JAX's live fleet parameters at atol 0. JAX's own
    AdapterStore replays the same records through plain sgd and misses
    them (open in the reference, ``src/repro/serve/adapters.py``)."""
    jrecs = ReplayLog.read(runs["jlog"])
    ts = AdapterStore(_tensors(runs["init"]), mezo_cfg=MZ, device="cpu")
    ts.put("fleet", jrecs)
    _assert_close(ts.materialize("fleet"), runs["jfinal"], 0.0)
    js = JAdapterStore(runs["jax_init"], mezo_cfg=JMZ)
    js.put("fleet", jrecs)
    ref = _flat(js.materialize("fleet"))
    assert max(float(np.abs(ref[k] - runs["jfinal"][k]).max())
               for k in ref) > 0.0


# ---------------------------------------------------------------------------
# the rule and the pieces, against the reference


@pytest.mark.parametrize("decay", [0.5, 0.8, 0.95, 1.0])
def test_staleness_coeffs_bit_equal_jax(decay):
    for stale in range(65):
        for mask in (None, np.array([1.0, 0.0, 1.0], np.float32)):
            got = engine._staleness_coeffs(3, torch.tensor(3e-3), mask,
                                           stale, decay).numpy()
            want = np.asarray(jengine._staleness_coeffs(
                3, jnp.float32(3e-3), mask, stale, decay))
            assert got.tobytes() == want.tobytes(), (stale, mask)


def test_staleness_scale_flushes_subnormals_as_xla():
    for stale in (120, 127, 140, 149, 150):
        got = engine._staleness_scale(0.5, stale).numpy()
        want = np.asarray(jnp.float32(0.5) ** jnp.asarray(stale,
                                                          jnp.float32))
        assert got.tobytes() == want.tobytes(), stale


def test_stale_sgd_staleness_zero_matches_sgd_bit_exact():
    w = np.linspace(-1, 1, 32, dtype=np.float32)
    params = {"w": torch.from_numpy(w)}
    gs = np.array([0.3, -0.7], np.float32)
    a, _ = SGD.update_fn(params, {}, np.uint32(7), gs, None, MZ)
    b, _ = STALE_SGD.update_fn(params, {}, np.uint32(7), gs, None, MZ)
    c, _ = STALE_SGD.update_fn(params, {}, np.uint32(7), gs, None, MZ,
                               staleness=0)
    assert _max_diff(a, b) == 0.0
    assert _max_diff(a, c) == 0.0
    d, _ = STALE_SGD.update_fn(params, {}, np.uint32(7), gs, None, MZ,
                               staleness=3)
    assert _max_diff(a, d) > 0.0                # decay actually applied
    # and the decayed update is JAX's, bit for bit (a mask too)
    mask = np.array([1.0, 0.0], np.float32)
    e, _ = STALE_SGD.update_fn(params, {}, np.uint32(7), gs, mask, MZ,
                               staleness=3)
    want, _ = jengine.STALE_SGD.update_fn(
        {"w": jnp.asarray(w)}, {},
        np.uint32(7), gs, mask, JMZ, staleness=3)
    np.testing.assert_array_equal(e["w"].numpy(), np.asarray(want["w"]))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_latency_model_and_counts_equal_jax(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert analysis.active_params(cfg) == j_analysis.active_params(jcfg)
    for mode in ("train", "train-adam", "prefill", "decode"):
        assert (analysis.model_flops(cfg, 4096, mode)
                == j_analysis.model_flops(jcfg, 4096, mode))
    for grade in ("flagship", "midrange", "budget"):
        for k in (1, 2, 4):
            assert (lease_latency_s(cfg, get_grade(grade), 1024, k)
                    == jfleet.lease_latency_s(jcfg, jfleet.get_grade(grade),
                                              1024, k))


def test_server_grade_is_the_h100_data_sheet():
    """The reference's "server" grade is a TPU's; the port's is the card
    it runs on (a settled divergence). The phone grades are equal."""
    assert DEVICE_GRADES["server"].peak_flops == 989e12
    assert DEVICE_GRADES["server"].mem_bw == 3.35e12
    assert set(DEVICE_GRADES) == set(jfleet.DEVICE_GRADES)
    for name in ("flagship", "midrange", "budget"):
        assert (dataclasses.astuple(DEVICE_GRADES[name])
                == dataclasses.astuple(jfleet.DEVICE_GRADES[name]))


def _shape_and_warnings(fn, *args):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        shape = fn(*args)
    return shape, [str(x.message) for x in w]


def test_mesh_shape_for_equals_jax_warnings_included():
    for n in range(1, 40):
        for mp in (1, 2, 4, 16):
            for dp in (1, 3, 4, 16):
                assert (_shape_and_warnings(elastic.mesh_shape_for, n, mp,
                                            dp)
                        == _shape_and_warnings(j_elastic.mesh_shape_for, n,
                                               mp, dp)), (n, mp, dp)


# ---------------------------------------------------------------------------
# inside the port: counterparts of tests/test_fleet.py


def test_faulty_elastic_run_replays_bit_exact(tmp_path):
    """Stragglers + duplicate deliveries + one mid-run join + one leave:
    the staleness-bearing log alone reconstructs live params at atol=0."""
    log = str(tmp_path / "fleet.jsonl")
    workers = [
        WorkerSpec("flagship", FaultSpec(jitter=0.2, duplicate_every=2)),
        WorkerSpec("flagship", FaultSpec(jitter=0.2)),
        WorkerSpec("flagship", FaultSpec(jitter=0.2)),
        WorkerSpec("flagship", FaultSpec(latency_scale=5.0)),  # straggler
    ]
    sim = FleetSim(CFG, workers, total_steps=20, mezo_cfg=MZ, batch=2,
                   seq=16, seed=0, log_path=log, device="cpu",
                   step_events=[(5, "join", WorkerSpec("flagship")),
                                (10, "leave", 2)])
    rep = sim.run()

    assert rep.applied == 20
    assert rep.resizes == 2                      # one join, one leave
    assert rep.dropped > 0                       # duplicates discarded
    assert max(rep.staleness) > 0                # genuinely async
    assert sorted(r["step"] for r in rep.records) == list(range(20))
    assert [r["step"] for r in rep.records] != list(range(20)), \
        "applies should arrive out of step order under async delivery"
    # a version per busy worker at most, plus the head
    assert 1 < rep.max_live_versions <= len(sim.workers) + 1

    replayed, last = replay_into(_init(0), ReplayLog.read(log), MZ)
    assert _max_diff(replayed, rep.params) == 0.0
    assert last == rep.records[-1]["step"]


def test_worker_death_mid_lease_reissues(tmp_path):
    log = str(tmp_path / "death.jsonl")
    base = lease_latency_s(CFG, get_grade("flagship"), 2 * 16,
                           MZ.n_directions)
    workers = [WorkerSpec("flagship", FaultSpec(jitter=0.1)),
               WorkerSpec("flagship", FaultSpec(die_at=base * 1.5))]
    sim = FleetSim(CFG, workers, total_steps=8, mezo_cfg=MZ, batch=2,
                   seq=16, seed=1, log_path=log, device="cpu")
    rep = sim.run()
    assert rep.applied == 8
    assert sorted(r["step"] for r in rep.records) == list(range(8))
    replayed, _ = replay_into(_init(1), ReplayLog.read(log), MZ)
    assert _max_diff(replayed, rep.params) == 0.0


def test_late_and_duplicate_deliveries_dropped_not_logged(tmp_path):
    log = str(tmp_path / "dup.jsonl")
    workers = [WorkerSpec("flagship", FaultSpec(duplicate_every=1)),
               WorkerSpec("flagship", FaultSpec(jitter=0.1)),
               WorkerSpec("flagship", FaultSpec(latency_scale=8.0))]
    sim = FleetSim(CFG, workers, total_steps=10, mezo_cfg=MZ, batch=2,
                   seq=16, seed=2, log_path=log, device="cpu")
    rep = sim.run()
    assert rep.applied == 10
    assert rep.dropped > 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")           # any warning fails
        recs = ReplayLog.read(log)
    assert len(recs) == 10                       # one record per step


def test_join_and_leave_resize_policy_and_params():
    params = {"w": torch.ones((4, 4))}
    c = FleetCoordinator(params, MZ, total_steps=4, n_workers=2, seed=0,
                         remesh=True)
    c._observe(0, 1.0)
    assert c.policy.total == 2
    wid = c.worker_join(now=0.0)
    assert wid == 2 and c.policy.total == 3
    assert c.policy.ema_latencies[-1] > 0
    c.worker_leave(0, now=0.0)
    assert c.policy.total == 2
    assert c.resizes == 2
    assert c.params["w"] is params["w"]         # re-meshed without a copy
    with pytest.raises(ValueError, match="not in the roster"):
        c.worker_leave(99, now=0.0)


def test_leave_orphans_inflight_leases_for_reissue():
    c = FleetCoordinator({"w": torch.ones(4)}, MZ, total_steps=3,
                         n_workers=2, seed=0)
    lease = c.next_lease(worker=1, now=0.0)
    assert lease.step == 0
    c.worker_leave(1, now=0.0)
    release = c.next_lease(worker=0, now=0.0)
    assert release.step == 0                    # orphaned step re-issued
    assert c.reissued == 1


def test_coordinator_validates_config():
    params = {"w": torch.ones(2)}
    with pytest.raises(ValueError, match="total_steps"):
        FleetCoordinator(params, MZ, total_steps=0, n_workers=1)
    with pytest.raises(ValueError, match="staleness_decay"):
        FleetCoordinator(params, MezoConfig(staleness_decay=0.0),
                         total_steps=1, n_workers=1)
    with pytest.raises(ValueError, match="pristine"):
        FleetSim(CFG, [WorkerSpec()], total_steps=1, estimator="walk",
                 device="cpu")
    with pytest.raises(ValueError, match="unknown device grade"):
        get_grade("abacus")
    with pytest.raises(ValueError, match="never fire"):
        FleetSim(CFG, [WorkerSpec()], total_steps=2, device="cpu",
                 step_events=[(2, "join", WorkerSpec())]).run()


def test_lease_latency_orders_device_grades():
    fast = lease_latency_s(CFG, get_grade("flagship"), 64, 2)
    slow = lease_latency_s(CFG, get_grade("budget"), 64, 2)
    assert 0 < fast < slow
    assert lease_latency_s(CFG, get_grade("flagship"), 64, 4) > fast


def test_replay_log_conflicting_duplicate_warns(tmp_path):
    path = str(tmp_path / "log.jsonl")
    log = ReplayLog(path)
    log.append(0, 7, [0.1], lr=1e-3, eps=1e-3)
    log.append(1, 8, [0.2], lr=1e-3, eps=1e-3)
    log.append(1, 8, [0.2], lr=1e-3, eps=1e-3)   # benign retry
    log.append(0, 9, [0.5], lr=1e-3, eps=1e-3)   # divergent retry!
    log.close()
    with pytest.warns(RuntimeWarning, match="conflicting duplicate"):
        recs = ReplayLog.read(path)
    assert [r["step"] for r in recs] == [0, 1]
    assert recs[0]["seed"] == 7                  # first-applied wins
    benign = str(tmp_path / "benign.jsonl")
    log = ReplayLog(benign)
    log.append(0, 7, [0.1], lr=1e-3, eps=1e-3)
    log.append(0, 7, [0.1], lr=1e-3, eps=1e-3)
    log.close()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert len(ReplayLog.read(benign)) == 1  # silent dedup


def test_mesh_shape_for_warns_on_stranded_devices():
    with pytest.warns(RuntimeWarning, match="stranding 8 of 24"):
        shape = elastic.mesh_shape_for(24, model_parallel=4,
                                       data_parallel=4)
    assert shape == (1, 4, 4)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert elastic.mesh_shape_for(32, 4, 4) == (2, 4, 4)


def test_held_lease_snapshot_is_never_written():
    """Leased snapshots are shared by reference: a lease held across
    later applies (and resizes) still equals a clone taken at lease time
    at atol 0, while the head moved on."""
    c = FleetCoordinator(_init(3), MZ, total_steps=6, n_workers=3, seed=4,
                         remesh=True, deadline_factor=1e9)   # no expiry
    held = c.next_lease(worker=0, now=0.0)
    clone = {k: v.clone() for k, v in held.params.items()}
    gs = np.array([0.5, -0.25], np.float32)
    for i in range(3):
        lease = c.next_lease(worker=1, now=float(i))
        assert c.submit(lease, gs, now=float(i) + 0.5)
        c.worker_join(now=float(i))
    assert c.version == 3 and held.version == 0
    assert _max_diff(held.params, clone) == 0.0
    assert _max_diff(c.params, clone) > 0.0
    assert c.submit(held, gs, now=9.0)          # applied 3 versions stale
    assert c.records[-1]["staleness"] == 3
    assert _max_diff(held.params, clone) == 0.0


# ---------------------------------------------------------------------------
# elastic meshes (tests/test_elastic.py)


def test_degraded_single_device_mesh():
    mesh = elastic.elastic_mesh(["cpu"], model_parallel=16,
                                data_parallel=16)
    assert mesh.axis_names == ("pod", "data", "model")
    assert mesh.devices.size == 1


def test_remesh_params_identity_on_one_device():
    params = {"w": torch.ones((8, 8)), "b": torch.zeros((4,))}
    mesh = elastic.elastic_mesh(["cpu"], model_parallel=1, data_parallel=1)
    out = elastic.remesh_params(params, mesh)
    for k in params:
        assert out[k] is params[k]              # values untouched, no copy
    with pytest.raises(ValueError, match="one device"):
        elastic.remesh_params(params, elastic.Mesh(
            np.array([torch.device("cpu"), torch.device("meta")],
                     dtype=object).reshape(2, 1, 1)))


# ---------------------------------------------------------------------------
# the CLI


def test_cli_verify_replay_and_out(tmp_path, capsys):
    out = tmp_path / "fleet.json"
    sim, rep, ok = fleet_cli.run([
        "--arch", "gemma-2b", "--reduced", "--device", "cpu",
        "--workers", "3", "--stragglers", "1", "--duplicate-every", "2",
        "--steps", "8", "--join-after", "2", "--leave-after", "5",
        "--log", str(tmp_path / "f.jsonl"), "--verify-replay",
        "--out", str(out)])
    assert ok is True and rep.applied == 8 and rep.resizes == 2
    assert "max |diff| = 0.0 (bit-exact)" in capsys.readouterr().out
    with open(out) as f:
        summary = json.load(f)
    # the reference CLI's --out keys
    assert set(summary) == {"arch", "workers", "stragglers", "steps",
                            "applied", "reissued", "dropped", "resizes",
                            "virtual_s", "virtual_steps_per_s",
                            "max_staleness", "losses", "replay_bitexact"}
    assert summary["replay_bitexact"] is True
    with pytest.raises(SystemExit):
        fleet_cli.run(["--reduced", "--device", "cpu", "--estimator",
                       "walk"])
    with pytest.raises(SystemExit):
        fleet_cli.run(["--reduced", "--device", "cpu", "--verify-replay"])


def test_multi_tenant_stale_sgd_is_sgd_bit_exact(tmp_path):
    """A multi-tenant step carries no staleness: ``--update stale-sgd``
    trains every user bit for bit as ``--update sgd`` (the reference
    vmaps the rule with staleness None)."""
    from repro_torch.launch import train_fleet
    logs = {}
    for rule in ("sgd", "stale-sgd"):
        logs[rule] = tmp_path / rule
        train_fleet.run(["--arch", "opt-1.3b", "--reduced", "--device",
                         "cpu", "--users", "3",
                         "--slots", "2", "--steps", "2", "--batch", "2",
                         "--seq", "8", "--update", rule, "--log-dir",
                         str(logs[rule])])
    files = sorted(p.name for p in logs["sgd"].iterdir())
    assert files == sorted(p.name for p in logs["stale-sgd"].iterdir())
    assert len(files) == 3
    for name in files:
        assert ((logs["sgd"] / name).read_text()
                == (logs["stale-sgd"] / name).read_text())
