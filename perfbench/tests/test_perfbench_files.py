"""Every file the benchmark finds by name is there and parses, and
``BENCHMARK.json`` keeps to the shape the harness relies on."""

import json
import re
from pathlib import Path

import pytest

from perfbench import bench, flops

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|"
                   r"_rank$|expan|experts_per_tok|ffn)", re.I)
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in METRICS:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_parses(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    for key in config["reduced"]:
        assert NAME.match(key) and not WIDTH.search(key), key
        assert key in data
    assert {"eps", "lr", "n_directions", "dist"} <= set(data["mezo"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found(name):
    cell = bench.load_cell(name, ROOT)
    wl = cell.workload
    assert (ROOT / "perfbench" / "drivers"
            / f"{wl['driver']}.py").exists()
    assert hasattr(bench.driver_module(cell), "Driver")
    assert {"task", "batch", "seq"} <= set(wl["traffic"])
    assert wl["limits"] and wl["control"] in ("fp8", "tf32")
    # every cell reports set-up, another end-to-end metric and a
    # per-layer one
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    assert callable(bench.reader(metric["name"]))
    for cell in metric.get("workloads", []):
        assert cell in CELLS


def test_per_layer_moves_and_layers():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("name,weights,head", [
    ("opt-1.3b", 1_310_916_608, 0),          # the (tied) LM head included
    ("roberta-large", 301_989_888, 1024 * 2)])  # the CLS head, once a row
def test_matmul_weights_per_token(name, weights, head):
    config = next(c for c in SPEC["configs"] if c["name"] == name)
    model = json.loads((ROOT / config["file"]).read_text())["model"]
    per_token = sum(k * n for _, k, n in flops.projections(model, 1, 1))
    assert per_token == weights + head


def test_step_flops_counts_attention_once_per_direction():
    model = {"d_model": 64, "d_ff": 128, "n_heads": 4, "n_layers": 2,
             "vocab": 100, "causal": True}
    mezo = {"n_directions": 2}
    b, s = 3, 8
    proj = 2 * b * s * (2 * (4 * 64 * 64 + 2 * 64 * 128) + 64 * 100)
    attn = 2 * 2 * b * 4 * s * s * 16 * 2 / 2
    assert flops.forward_flops(model, b, s) == proj + attn
    assert flops.step_flops(model, mezo, b, s) == 4 * (proj + attn)
    enc = dict(model, causal=False, n_classes=2)
    head = 2 * b * 64 * 2
    assert flops.forward_flops(enc, b, s) == (
        2 * b * s * 2 * (4 * 64 * 64 + 2 * 64 * 128) + head + 2 * attn)
