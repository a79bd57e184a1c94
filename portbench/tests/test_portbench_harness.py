"""The harness on the CPU: BENCHMARK.json against the contract's shape,
cells, configurations and metrics found by name, the last line's shape,
the whole-name import check, and the exit without a card."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest
import torch

from portbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_shape(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]] + \
        [w["name"] for w in spec["workloads"]] + \
        [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in spec["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


def test_every_cell_finds_its_files(spec):
    used = set()
    for cell in spec["workloads"]:
        c, entry, config, traffic = run.cell_of(spec, cell["name"])
        used.add(entry["name"])
        assert c["chips"] == 1
        assert (run.ROOT / "portbench" / "drivers"
                / f"{traffic['driver']}.py").exists()
        e2e = run.metrics_of(spec, cell["name"], trace=False)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        per = run.metrics_of(spec, cell["name"], trace=True)
        assert per
        for m in per:
            assert m["moves"] in names
        for m in e2e + per:
            assert callable(run.reader(m["name"]))
    assert used == {c["name"] for c in spec["configs"]}


def test_check_budget_fits_every_later_check(spec):
    # 24 cells: 2 + 14 * 24 runs at run_seconds + 60, 2 * 90 s a cell to
    # compile, 1,200 s spare, within 43,200 s
    s = spec["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200


def test_unknown_cell_is_refused(spec):
    with pytest.raises(KeyError):
        run.cell_of(spec, "no.such.cell")


@pytest.mark.parametrize("names, found", [
    (["rad_tpu_torch", "rad_tpu_torch.traverse", "torch", "numpy"], []),
    (["rad_tpu"], ["rad_tpu"]),
    (["rad_tpu.fp.kernels", "rad_tpu_torch"], ["rad_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "rad_tpu_extra"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert run.forbidden_modules(names) == found


def test_no_card_exits_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "shard333m_m8.tanimoto_b1024", "--seed", str(2 ** 31 + 7),
         "--seconds", "1", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_process_age_is_positive():
    assert 0 < run.process_age_s() < 1e7


def test_last_line_shape(table_spec):
    line = run.run_cell(
        table_spec, "shard333m_m8.table_b1024", 2 ** 33 + 1, 0.2, False,
        torch.device("cpu"),
        sizes=dict(n_nodes=5000, batch=32, n_to_score=800,
                   frontier_capacity=2048, head_capacity=256,
                   buffer_capacity=128))
    assert line.pop("_forbidden") == []
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"device_scored_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)
