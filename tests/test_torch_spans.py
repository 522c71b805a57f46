"""The span recorder (``repro_torch.core.spans``) and the attribution of
device and idle time to spans (``perfbench/spans.py``).

On the CPU, at a reduced OPT-1.3B:
  * the recorder: nesting, parents, self time; off it records
    nothing and hands out the shared no-op;
  * tracing changes no bits: a fused ``Trainer`` step and a
    ``TrainEngine`` dispatch give the same losses, gs and parameters at
    atol 0 with the recorder on and off;
  * the spans a step records: 2K ``zo.forward``, one ``zo.sync``, one
    ``zo.update``, 2 n_layers + 1 ``model.norm`` a forward; the walk's
    ``zo.perturb``; the engine's ``engine.admit`` / ``engine.flush``
    counts equal to ``TrainStats.admitted`` / ``finished``;
  * the clock: a span around an aten op contains the op's event of a CPU
    ``torch.profiler`` trace once both are on Unix nanoseconds;
  * the attribution and the per-layer numbers against synthetic spans
    and a synthetic trace.
One ``gpu``-marked test traces a step on the card: at least 99 % of its
device time lies under a span.
"""

import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import spans as ps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import spans  # noqa: E402
from repro_torch.core.engine import MezoConfig, build_strategy  # noqa: E402
from repro_torch.runtime import Trainer, TrainerConfig  # noqa: E402
from repro_torch.serve import AdapterStore  # noqa: E402
from repro_torch.train import TrainEngine, TrainJob  # noqa: E402

B, S, K = 2, 8, 2
MZ = MezoConfig(eps=1e-3, lr=1e-3, n_directions=K)


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


def _cfg():
    return get_config("opt-1.3b").reduced()


def _batches(n, salt=0):
    out = []
    for step in range(n):
        rng = np.random.default_rng((salt, step))
        toks = rng.integers(0, _cfg().vocab, (B, S + 1), dtype=np.int32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:],
                    "loss_mask": np.ones((B, S), np.float32)})
    return out


class _Gs:
    """The strategy with each step's gs kept."""

    def __init__(self, inner):
        self.inner, self.gs = inner, []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def step(self, *args, **kwargs):
        state, aux = self.inner.step(*args, **kwargs)
        self.gs.append(aux.gs.clone())
        return state, aux


def _train(estimator, n_steps, on):
    tr = Trainer(_cfg(), TrainerConfig(
        estimator=estimator, update="sgd", mezo=MZ, n_steps=n_steps,
        seed=3, log_every=10 ** 6, device="cpu"), iter(_batches(n_steps)),
        log_fn=lambda s: None)
    tr.strategy = _Gs(tr.strategy)
    params = tr.init_params()
    if on:
        spans.enable()
    out = tr.train(params=params)
    spans.disable()
    return tr, out, spans.take()[1]


def _names(rows):
    return [r.name for r in rows]


# -- the recorder ---------------------------------------------------------


def test_recorder_nesting_parents_and_self_time():
    spans.enable()
    with spans.span("a"):
        time.sleep(0.002)
        with spans.span("b"):
            time.sleep(0.002)
        with spans.span("c"):
            with spans.span("c.sync"):
                pass
    with spans.span("d"):
        pass
    spans.disable()
    anchor, rows = spans.take()
    assert _names(rows) == ["a", "b", "c", "c.sync", "d"]
    assert [r.parent for r in rows] == [-1, 0, 0, 2, -1]
    for r in rows:
        assert r.t0_ns <= r.t1_ns
        if r.parent >= 0:
            p = rows[r.parent]
            assert p.t0_ns <= r.t0_ns and r.t1_ns <= p.t1_ns
    own = ps.self_ns(rows)
    assert own[0] == (rows[0].t1_ns - rows[0].t0_ns
                      - (rows[1].t1_ns - rows[1].t0_ns)
                      - (rows[2].t1_ns - rows[2].t0_ns))
    assert own[0] >= 1_000_000 and own[1] >= 1_000_000
    assert anchor[0] > 10 ** 18                  # Unix ns, not perf ns
    assert spans.take()[1] == []                 # take() cleared it


def test_recorder_off_records_nothing():
    assert spans.span("x") is spans.NOOP
    with spans.span("x") as s:
        assert s is spans.NOOP
    spans.enable()
    spans.disable()
    assert spans.span("y") is spans.NOOP
    with spans.span("y"):
        pass
    assert spans.take()[1] == []


def test_enable_drops_spans_left_open():
    spans.enable()
    outer = spans.span("outer")
    outer.__enter__()
    spans.enable()                               # restarts the record
    with spans.span("inner"):
        pass
    outer.__exit__(None, None, None)
    spans.disable()
    rows = spans.take()[1]
    assert _names(rows) == ["inner"] and rows[0].parent == -1


# -- tracing changes no bits ------------------------------------------------


@pytest.mark.parametrize("estimator", ["fused", "walk"])
def test_trainer_bits_equal_with_spans_on(estimator):
    off_tr, off, rows_off = _train(estimator, 2, on=False)
    on_tr, on, rows_on = _train(estimator, 2, on=True)
    assert rows_off == [] and rows_on
    assert on_tr.losses == off_tr.losses
    for a, b in zip(on_tr.strategy.gs, off_tr.strategy.gs):
        assert torch.equal(a, b)
    assert set(on) == set(off)
    for k in off:
        assert torch.equal(on[k], off[k]), k


def _engine(on, slots=2):
    tr = Trainer(_cfg(), TrainerConfig(seed=3, device="cpu"), iter(()))
    store = AdapterStore(tr.init_params(), mezo_cfg=MZ,
                         update_rule=build_strategy("fused", "sgd").update,
                         device="cpu")
    eng = TrainEngine(_cfg(), store, n_slots=slots, estimator="fused",
                      update="sgd", seed=5, mezo_cfg=MZ)
    for j, n in enumerate((2, 3, 1)):
        eng.submit(TrainJob(user=f"u{j}", batches=_batches(n, salt=j),
                            n_steps=n))
    if on:
        spans.enable()
    results = eng.run()
    spans.disable()
    return eng, results, spans.take()[1]


def test_engine_bits_equal_with_spans_on():
    eng_off, res_off, rows_off = _engine(False)
    eng_on, res_on, rows_on = _engine(True)
    assert rows_off == [] and rows_on
    assert [r.losses for r in res_on] == [r.losses for r in res_off]
    assert [r.records for r in res_on] == [r.records for r in res_off]
    for u in ("u0", "u1", "u2"):
        a, b = eng_on.store.materialize(u), eng_off.store.materialize(u)
        for k in a:
            assert torch.equal(a[k], b[k]), (u, k)


# -- the spans a step records -----------------------------------------------


def test_fused_step_span_counts():
    tr, _, rows = _train("fused", 1, on=True)
    c = ps.counts(rows)
    n_layers = _cfg().n_layers
    assert c["trainer.step"] == 1 and c["trainer.batch"] == 1
    assert c["zo.estimate"] == 1
    assert c["zo.forward"] == 2 * K
    assert c["zo.sync"] == 1 and c["zo.update"] == 1
    assert c["model.norm"] == 2 * K * (2 * n_layers + 1)
    assert c["model.embed"] == c["model.head_loss"] == 2 * K
    assert c["model.mixer.attention"] == c["model.mixer.mlp"] \
        == 2 * K * n_layers
    assert "zo.perturb" not in c                 # fused: no sweep
    assert c["trainer.losses.sync"] == 1         # step 0 (log_every)
    # every forward's norms lie under a zo.forward under zo.estimate
    by = {i: r for i, r in enumerate(rows)}
    for r in rows:
        if r.name == "model.norm":
            chain, j = [], r.parent
            while j >= 0:
                chain.append(by[j].name)
                j = by[j].parent
            assert chain[:3] == ["zo.forward", "zo.estimate",
                                 "trainer.step"], chain
    fw = [r for r in rows if r.name == "zo.forward"]
    assert all(by[r.parent].name == "zo.estimate" for r in fw)


def test_walk_step_has_its_sweeps():
    _, _, rows = _train("walk", 1, on=True)
    c = ps.counts(rows)
    assert c["zo.perturb"] == 3 * K and c["zo.forward"] == 2 * K
    assert c["zo.sync"] == 1 and c["zo.update"] == 1


def test_engine_admit_and_flush_counts():
    eng, results, rows = _engine(True)
    c = ps.counts(rows)
    assert c["engine.admit"] == eng.stats.admitted == 3
    assert c["engine.flush"] == eng.stats.finished == 3
    assert c["engine.flush.sync"] == 3
    assert c["engine.dispatch"] >= eng.stats.dispatches
    assert c["engine.batch"] == eng.stats.dispatches
    assert c["zo.forward"] == K * eng.stats.dispatches   # both signs at once
    assert c["engine.batch.sync"] == eng.stats.dispatches
    for r in rows:
        if r.name in ("engine.admit", "engine.batch"):
            assert rows[r.parent].name == "engine.dispatch"
        if r.name == "engine.flush.sync":
            assert rows[r.parent].name == "engine.flush"


# -- the clock --------------------------------------------------------------


def test_span_contains_its_profiled_op():
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans.enable()
        with spans.span("mm"):
            x @ x
        spans.disable()
    anchor, rows = spans.take()
    (t0, t1), = ps.to_unix(anchor, rows)
    start = prof.profiler.kineto_results.trace_start_ns()
    (ev,) = [e for e in prof.events() if e.name == "aten::mm"]
    e0 = start + ev.time_range.start * 1000
    e1 = start + ev.time_range.end * 1000
    assert t0 - 1_000_000 <= e0 and e1 <= t1 + 1_000_000
    assert e1 - e0 <= t1 - t0 + 1_000_000


# -- the attribution against a synthetic trace ------------------------------


def _synthetic():
    """Spans on perf ns with anchor (1000, 0): step [0, 100) holding
    norm [10, 20), head [30, 40), x.sync [60, 90); device events in Unix
    ns, launched at 1015 (norm), 1035 (head), 1050 (step), 1200 (outside
    every span) and one with no launch record; launch calls of 3 ns, 5
    at 1200, and one more of [1085, 1095) half inside x.sync."""
    S_ = spans.Span
    rows = [S_("trainer.step", -1, 0, 100),
            S_("model.norm", 0, 10, 20),
            S_("model.head_loss", 0, 30, 40),
            S_("x.sync", 0, 60, 90)]
    devices = [ps.Device("norm_k", 1100, 1110, 1),
               ps.Device("head_k", 1120, 1150, 2),
               ps.Device("step_k", 1160, 1180, 3),
               ps.Device("late_k", 1210, 1230, 4),
               ps.Device("orphan", 1240, 1250, 5)]
    launches = {1: (1015, 1018), 2: (1035, 1038), 3: (1050, 1053),
                4: (1200, 1205), 6: (1085, 1095)}
    return (1000, 0), rows, ps.Window(devices, launches, 1000, 1300)


def test_attribution_device_and_idle_by_span():
    anchor, rows, win = _synthetic()
    attr = ps.Attribution(anchor, rows, win)
    assert attr.owner == [1, 2, 0, -1, None]
    assert attr.device_s == pytest.approx(90e-9)
    assert attr.attributed_share() == pytest.approx(60 / 90)
    assert attr.device_self_s() == pytest.approx(
        {"model.norm": 10e-9, "model.head_loss": 30e-9,
         "trainer.step": 20e-9, "-": 20e-9, "?": 10e-9})
    assert sum(attr.device_self_s().values()) == pytest.approx(
        attr.device_s)
    assert attr.device_under_s("trainer.step") == pytest.approx(60e-9)
    # gaps: [1000, 1100) before norm_k, [1110, 1120) before head_k,
    # [1150, 1160) before step_k, [1180, 1210) before late_k, [1230,
    # 1240) before the orphan, [1250, 1300) the tail
    assert attr.idle_s() == pytest.approx(
        {"model.norm": 100e-9, "model.head_loss": 10e-9,
         "trainer.step": 10e-9, "-": 30e-9, "?": 10e-9, "end": 50e-9})
    bd = attr.breakdown(top=2)
    assert [k for k, _ in bd["device_by_span"]] == ["model.head_loss",
                                                     "trainer.step"]
    assert [k for k, _ in bd["idle_by_span"]] == ["model.norm", "end"]


def test_per_layer_numbers_on_synthetic_spans():
    anchor, rows, win = _synthetic()
    attr = ps.Attribution(anchor, rows, win)
    assert ps.device_pct(attr, "model.norm") == pytest.approx(100 * 10 / 90)
    assert ps.device_pct(attr, "model.head_loss") == pytest.approx(
        100 * 30 / 90)
    assert ps.device_pct(attr, "engine.admit") is None
    assert ps.device_pct(None, "model.norm") is None
    # the window [1000, 1300) Unix holds x.sync at [1060, 1090)
    assert ps.host_busy_pct(anchor, rows, 1000, 1300) == pytest.approx(
        100 * (1 - 30 / 300))
    assert ps.host_busy_pct(anchor, rows, 1070, 1080) == pytest.approx(0)
    assert ps.host_busy_pct(anchor, [], 1000, 1300) is None
    # launch calls outside x.sync: 3 + 3 + 3 + 5 + the 5 past 1090
    assert ps.host_launch_pct(anchor, rows, win) == pytest.approx(
        100 * 19 / 300)
    assert ps.host_launch_pct(anchor, [], win) is None
    assert ps.host_launch_pct(anchor, rows, win, over_us=4e-3) == \
        pytest.approx(100 * 10 / 300)           # the two calls over 4 ns
    assert ps.launch_us(win) == pytest.approx([3e-3] * 3 + [5e-3, 10e-3])
    S_ = spans.Span
    jobs = [S_("engine.admit", -1, 0, 2_000_000),
            S_("engine.admit", -1, 5, 4_000_005),
            S_("engine.flush", -1, 0, 10_000_000)]
    assert ps.ms_per_span(jobs, "engine.admit") == pytest.approx(3.0)
    assert ps.ms_per_span(jobs, "engine.flush") == pytest.approx(10.0)
    assert ps.ms_per_span(jobs, "engine.batch") is None


def test_union_of_overlapping_waits():
    assert ps.union_ns([(0, 10), (5, 20), (30, 40)]) == 30
    assert ps.union_ns([]) == 0


# -- on the card --------------------------------------------------------------


@pytest.mark.gpu
def test_traced_step_on_the_card_is_attributed():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")
    import dataclasses
    cfg = dataclasses.replace(_cfg(), dtype="bfloat16")
    feed = iter(_batches(4))
    tr = Trainer(cfg, TrainerConfig(
        estimator="fused", update="sgd", mezo=MZ, n_steps=2, seed=3,
        log_every=10 ** 6, device="cuda"), feed, log_fn=lambda s: None)
    params = tr.train()                          # builds and warms up
    spans.enable()
    _, win = ps.traced(lambda: tr.train(params=params),
                       torch.cuda.synchronize)
    spans.disable()
    anchor, rows = spans.take()
    attr = ps.Attribution(anchor, rows, win)
    assert win.devices and attr.attributed_share() >= 0.99
    assert sum(attr.device_self_s().values()) == pytest.approx(
        attr.device_s, rel=1e-9)
    assert attr.device_under_s("model.norm") > 0
