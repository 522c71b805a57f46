"""The Jamba cell (``jamba2-mini.fused-b2s4096``) on the CPU, at a tiny
size (one 8-layer period of width 64, 4 experts top-2, B 2 x S 32): its
files load and keep the published shapes, a sound run is correct, the
fp8 control reads far above it, three faults under the timed path are
not correct, the reference settles near ties in routing as its docstring
says, and the two readers it adds read what they should (and nothing
from a run without their numbers)."""

import dataclasses
import json
from pathlib import Path

import pytest

from perfbench import bench
from perfbench.run import run_cell
from perfbench.tests.test_perfbench_reference import (_gs_altered,
                                                      _half_batch,
                                                      _unchanged)
from perfbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
CELL = "jamba2-mini.fused-b2s4096"
TINY = dict(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=128, n_experts=4, expert_dff=64, max_seq=64)
SEED = 2 ** 32 + 91


def tiny_cell(dtype=None):
    cell = bench.load_cell(CELL, ROOT)
    model = dict(cell.model, **TINY, **({"dtype": dtype} if dtype else {}))
    wl = dict(cell.workload,
              traffic=dict(cell.workload["traffic"], batch=2, seq=32))
    return dataclasses.replace(cell, config=dict(cell.config, model=model),
                               workload=wl)


def test_cell_keeps_the_published_shapes():
    cell = bench.load_cell(CELL, ROOT)
    c, m = cell.config, cell.model
    assert cell.entry["chips"] == 1
    assert cell.workload["driver"] == "hybrid_trainer"
    assert cell.workload["traffic"] == {"task": "lm", "batch": 2,
                                        "seq": 4096}
    pairs = {"hidden_size": "d_model", "intermediate_size": "expert_dff",
             "num_attention_heads": "n_heads",
             "num_key_value_heads": "n_kv_heads", "num_experts": "n_experts",
             "num_experts_per_tok": "topk", "vocab_size": "vocab",
             "mamba_d_state": "mamba_d_state", "mamba_d_conv": "mamba_d_conv",
             "mamba_expand": "mamba_expand",
             "attn_layer_period": "block_len",
             "attn_layer_offset": "attn_index",
             "num_hidden_layers": "n_layers"}
    for src, port in pairs.items():
        assert c[src] == m[port], (src, port)
    assert m["d_ff"] == c["intermediate_size"]
    assert c["mamba_dt_rank"] == m["d_model"] // 16
    assert c["expert_layer_period"] == 2 and c["expert_layer_offset"] == 1
    assert m["capacity_factor"] is None and m["moe_renorm"] is False
    assert m["mamba_inner_norm"] and not m["tie_embeddings"]
    assert c["tie_word_embeddings"] is False and m["pos"] == "none"
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(x for x in spec["configs"] if x["name"] == "jamba2-mini")
    assert entry["reduced"] == ["num_hidden_layers"]


def test_sound_run_is_correct():
    r = run_cell(tiny_cell("float32"), SEED, 0.2, False, "cpu")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_control_reads_far_above_the_sound_run():
    """In the configuration's bf16, the fp8 control's loss gap is several
    times the program's (the cell's limit itself is set from readings at
    the timed size on the card: PERF.md section 2)."""
    cell = tiny_cell()
    drv = bench.driver_module(cell).Driver(cell, SEED, "cpu", 0.0)
    drv.setup(size_window=False)
    prog = drv.program_readings()
    drv.free()
    ref = drv.reference_readings()
    low = drv.reference_readings(precision=cell.workload["control"])
    sound = drv.numbers(prog, ref, drv.update_readings(prog))
    control = drv.numbers(low, ref, drv.update_readings(low))
    assert sound["update_gap"] == 0
    assert control["loss_gap"] > 4 * sound["loss_gap"], (sound, control)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _gs_altered],
                         ids=["state_unchanged", "half_batch", "gs_altered"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = run_cell(tiny_cell("float32"), SEED, 0.2, False, "cpu")
    assert not r["correct"], r["checks"]


def test_near_ties_take_the_programs_experts():
    """A token takes the program's top-2 where each choice is within the
    bf16 rounding of the router's input of the reference's own, and keeps
    its own elsewhere (an order swap at a wide gap included)."""
    import torch
    from perfbench.reference import jamba as ref
    g = torch.Generator().manual_seed(3)
    xf, router = torch.ones(3, 8), torch.randn(8, 4, generator=g) * 0.02
    logits = torch.tensor([[3.0, 2.0, 2.0 - 1e-5, 0.0],
                           [3.0, 2.0, 1.0, 0.0], [3.0, 2.0, 1.0, 0.0]])
    own = torch.topk(logits, 2).indices
    got = torch.tensor([[0, 2], [0, 2], [1, 0]])
    tol = ref.TIE_ROUNDING * (router[:, 1] - router[:, 2]).abs().sum()
    assert 1e-5 < tol < 1.0
    idx, taken, flips = ref._ties(xf, router, logits, own, got)
    assert idx.tolist() == [[0, 2], [0, 1], [0, 1]]
    assert (taken, flips) == (1, 1)


def _record(work, counters, events):
    return bench.RunRecord(cell=bench.load_cell(CELL, ROOT), setup_s=1.0,
                           window_s=2.0, work=work, mem_peak=0, mem_start=0,
                           counters=counters,
                           trace=Trace(events, 2.0) if events else None)


def test_new_readers():
    scan = bench.reader("selective_scan_roofline")
    waste = bench.reader("moe_row_waste_pct")
    events = [("void repro_torch::scan::selective_scan_kernel<float, 16>()",
               0.0, 400.0), ("zo_matmul_tc_kernel", 400.0, 900.0)]
    run = _record({"selective_scan_bound_s": 1e-4},
                  {"moe": {"rows": 2048, "assignments": 1536}}, events)
    assert scan(run) == pytest.approx(25.0)
    assert waste(run) == pytest.approx(25.0)
    # a run whose program has neither the kernel nor the counters
    bare = _record({"steps": 1}, {}, [("zo_matmul_tc_kernel", 0.0, 1.0)])
    assert scan(bare) is None and waste(bare) is None
    assert scan(_record({"selective_scan_bound_s": 1e-4}, {}, None)) is None
