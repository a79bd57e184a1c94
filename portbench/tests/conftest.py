"""Fixtures: the benchmark as committed, and with the table cell that
waits under PERF.md's open questions (its traffic file and scorer are
kept, so that the cell returns by a ``BENCHMARK.json`` entry alone)."""

from __future__ import annotations

import copy

import pytest

from portbench import run

TABLE_CELL = {"name": "shard333m_m8.table_b1024",
              "config": "zinc22_shard_333m_m8", "traffic": "table_b1024",
              "chips": 1, "why": "campaigns scored from a [N] f32 table"}


@pytest.fixture(scope="session")
def spec():
    return run.load_spec()


@pytest.fixture(scope="session")
def table_spec(spec):
    """A copy of the committed spec with the table cell added to the
    workloads and to every metric that the Tanimoto cell reports."""
    out = copy.deepcopy(spec)
    out["workloads"].append(dict(TABLE_CELL))
    for m in out["end_to_end"] + out["per_layer"]:
        if "shard333m_m8.tanimoto_b1024" in m.get("workloads", ()):
            m["workloads"].append(TABLE_CELL["name"])
    return out
