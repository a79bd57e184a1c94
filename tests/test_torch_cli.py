"""The port's command lines: ``python -m rad_tpu_torch.scripts.build_index``
and ``python -m rad_tpu_torch.scripts.start_hnsw_server``.

The cases of ``tests/test_cli.py`` with ``--device cpu``, the CLI's
``.npz`` edge-identical to the ``HNSWIndex(..., device="cpu")`` build of
the same fingerprints, and the port's CLI writing the files the repo's
``scripts/build_index.py`` writes.
"""

import json
import os
import signal
import socket
import sqlite3
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from rad_tpu_torch.scripts import build_index, start_hnsw_server

REPO = str(Path(__file__).resolve().parent.parent)
MOLS = [(100 + i, f"C{'C' * (i % 7)}N{i % 5}O{i % 3}") for i in range(150)]


def _mol_file(tmp_path):
    f = tmp_path / "mols.smi"
    f.write_text("\n".join(f"{k}\t{s}" for k, s in MOLS) + "\n")
    return str(f)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait_up(url, seconds):
    deadline = time.time() + seconds
    while time.time() < deadline:
        try:
            urllib.request.urlopen(url + "/ping", timeout=1)
            return
        except Exception:
            time.sleep(0.2)
    pytest.fail("server did not come up")


@pytest.mark.parametrize("backend", ["host", "auto"])
def test_build_index_cli_end_to_end(tmp_path, backend):
    out = str(tmp_path / "lib")
    rc = build_index.main([_mol_file(tmp_path), "--out", out, "--ndim",
                           "128", "--connectivity", "6", "--expansion-add",
                           "24", "--backend", backend, "--device", "cpu"])
    assert rc == 0
    assert (tmp_path / "lib.npz").exists()
    assert (tmp_path / "lib.db").exists()

    from rad_tpu_torch import HNSWIndex, create_local_traverser
    from rad_tpu_torch.store import SQLiteSmilesStore

    index = HNSWIndex.load(out + ".npz", view=True, device="cpu")
    assert len(index) == 150
    store = SQLiteSmilesStore(out + ".db")
    assert len(store) == 150
    smi_map = {s: i for i, (k, s) in enumerate(MOLS)}

    def scoring_fn(smiles):
        return float(smi_map[smiles])

    t = create_local_traverser(index, scoring_fn, smiles_store=store,
                               n_score_threads=1)
    t.prime()
    t.traverse(n_to_score=50)
    mols_out = t.get_molecules()
    assert len(mols_out) >= 50
    ids = [m[0] for m in mols_out]
    assert len(ids) == len(set(ids))
    for nid, score, smi in mols_out[:10]:
        assert smi != "" and scoring_fn(smi) == score
    t.shutdown()


def test_build_index_reads_bare_smiles(tmp_path):
    f = tmp_path / "bare.smi"
    f.write_text("CCO\nCCN\nc1ccccc1\n")
    keys, smiles = build_index.read_molecules(str(f), None)
    assert keys == [0, 1, 2]
    assert smiles == ["CCO", "CCN", "c1ccccc1"]


def test_cli_npz_edge_identical_to_api_build(tmp_path):
    """--backend auto --device cpu: the exact builder through its plain
    twins, the same graph as the API build of the same fingerprints."""
    from rad_tpu_torch import HNSWIndex
    from rad_tpu_torch.fp import smiles_fingerprints
    from rad_tpu_torch.graph.storage import HNSWGraph

    out = str(tmp_path / "lib")
    assert build_index.main([_mol_file(tmp_path), "--out", out, "--ndim",
                             "256", "--connectivity", "4", "--device",
                             "cpu"]) == 0
    g = HNSWGraph.load(out + ".npz")
    index = HNSWIndex(ndim=256, connectivity=4, device="cpu")
    index.add(np.asarray([k for k, _ in MOLS], np.int64),
              smiles_fingerprints([s for _, s in MOLS], n_bits=256))
    api = index.build()
    for name in ("packed", "popcounts", "keys", "levels"):
        assert np.array_equal(np.asarray(getattr(g, name)),
                              np.asarray(getattr(api, name))), name
    assert len(g.neighbors) == len(api.neighbors) > 1
    for a, b in zip(g.neighbors, api.neighbors):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_cli_writes_the_reference_cli_files(tmp_path):
    """--backend host: the same .npz members and SMILES rows as the
    repo's scripts/build_index.py (rad_tpu's host builder)."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import build_index as ref_cli
    finally:
        sys.path.pop(0)
    args = [_mol_file(tmp_path), "--ndim", "128", "--connectivity", "6",
            "--expansion-add", "24", "--backend", "host"]
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    assert ref_cli.main(args + ["--out", a]) == 0
    assert build_index.main(args + ["--out", b, "--device", "cpu"]) == 0
    za, zb = np.load(a + ".npz"), np.load(b + ".npz")
    assert sorted(za.files) == sorted(zb.files)
    for name in za.files:
        assert np.array_equal(za[name], zb[name]), name

    def rows(path):
        with sqlite3.connect(path) as c:
            return sorted(c.execute("SELECT * FROM nodes").fetchall())

    assert rows(a + ".db") == rows(b + ".db") != []


def test_server_cli_enable_coordination(tmp_path):
    """--enable-coordination: remote workers can register; malformed
    bodies get 400."""
    port = _free_port()
    threading.Thread(
        target=start_hnsw_server.main,
        args=(["--test-data", "80", "--host", "127.0.0.1",
               "--port", str(port), "--enable-coordination",
               "--cache-dir", str(tmp_path)],),
        daemon=True).start()
    url = f"http://127.0.0.1:{port}"
    _wait_up(url, 30)
    req = urllib.request.Request(
        url + "/coordination/register", data=b"{}",
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=5) as r:
        assert json.loads(r.read().decode())["worker_id"].startswith("http-")
    bad = urllib.request.Request(
        url + "/coordination/heartbeat", data=b"{}",
        headers={"Content-Type": "application/json"}, method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(bad, timeout=5)
    assert e.value.code == 400


def test_server_cli_workers_reuseport(tmp_path):
    """--workers 2 as users start it (python -m): two processes share the
    port, and requests keep succeeding."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "rad_tpu_torch.scripts.start_hnsw_server",
         "--test-data", "60", "--test-dim", "64", "--host", "127.0.0.1",
         "--port", str(port), "--workers", "2", "--cache-dir",
         str(tmp_path)],
        cwd=str(tmp_path), env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL, start_new_session=True)
    try:
        url = f"http://127.0.0.1:{port}"
        _wait_up(url, 60)
        pids = set()
        for _ in range(20):
            with urllib.request.urlopen(url + "/health", timeout=5) as r:
                body = json.loads(r.read().decode())
            assert body["status"] == "healthy"
            pids.add(body.get("pid"))
        assert len(pids - {None}) >= 1
        with urllib.request.urlopen(url + "/neighbors/0/0", timeout=5) as r:
            assert json.loads(r.read().decode())["node_id"] == 0
    finally:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=10)
