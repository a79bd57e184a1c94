"""The generators: the same seed gives the same inputs, another seed other
ones, and the graph keeps its shape rules."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.gen import sub_seed
from portbench.gen.bits import random_words, uniform_table
from portbench.gen.graph import layer_sizes, make_graph, top_ids
from portbench.gen.library import make_library, popcount_rows

CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 64 + 3, -12])
def test_sub_seed_takes_any_whole_number(seed):
    a = sub_seed(seed, 1)
    assert a == sub_seed(seed, 1) and 0 <= a < 2 ** 63
    assert a != sub_seed(seed, 2) and a != sub_seed(seed + 1, 1)


def test_layer_sizes():
    assert layer_sizes(100_000_000, 8) == [
        100000000, 12500000, 1562500, 195312, 24414, 3052, 381, 48, 6, 1]
    assert top_ids(layer_sizes(100_000_000, 8)) == 6
    assert layer_sizes(333_333_334, 8) == [
        333333334, 41666667, 5208333, 651042, 81380, 10173, 1272, 159, 20,
        2]
    assert top_ids(layer_sizes(333_333_334, 8)) == 2
    assert top_ids([1000, 63, 4]) == 4


def test_graph_is_seeded_and_keeps_its_shape_rules():
    n, m = 6000, 4
    adj, offsets, sizes = make_graph(n, m, sub_seed(9, 1), CPU, n_chunks=7)
    again, _, _ = make_graph(n, m, sub_seed(9, 1), CPU, n_chunks=3)
    other, _, _ = make_graph(n, m, sub_seed(10, 1), CPU)
    assert torch.equal(adj, again)
    assert not torch.equal(adj, other)
    assert adj.shape == (sum(sizes), 2 * m) and adj.dtype == torch.int32
    assert list(offsets) == [0, *np.cumsum(sizes), sum(sizes)]
    for level, nl in enumerate(sizes):
        rows = adj[offsets[level]:offsets[level + 1]]
        node = torch.arange(nl)[:, None]
        if nl == 1:
            assert (rows == -1).all()
            continue
        cap = 2 * m if level == 0 else m
        assert (rows[:, cap:] == -1).all()
        live = rows[:, :cap]
        assert ((live >= 0) & (live < nl)).all()
        assert (live != node).all()


def test_words_and_tables_are_seeded():
    a = random_words(1000, 32, 5, CPU, step=300)
    assert torch.equal(a, random_words(1000, 32, 5, CPU, step=300))
    assert not torch.equal(a, random_words(1000, 32, 6, CPU, step=300))
    t = uniform_table(500, 3, CPU)
    assert torch.equal(t, uniform_table(500, 3, CPU))
    assert ((t >= 0) & (t < 1)).all()


def test_library_is_seeded_and_never_empty():
    p, s = make_library(6000, seed=11, batch=1000)
    p2, s2 = make_library(6000, seed=11, batch=1000)
    assert np.array_equal(p, p2) and np.array_equal(s, s2)
    p3, _ = make_library(6000, seed=12, batch=1000)
    assert not np.array_equal(p, p3)
    assert p.shape == (6000, 32) and p.dtype == np.uint32
    pops = popcount_rows(p)
    assert pops.min() > 0 and 0.08 < pops.mean() / 1024 < 0.16
