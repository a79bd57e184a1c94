"""The port's multi-process mesh: 2 gloo processes × 2 CPU devices.

The counterpart of ``tests/test_multihost.py``: ``initialize_multihost``
(twice: it is idempotent) and ``global_mesh`` over two processes on
localhost, each driving two shards of a 4-shard mesh and holding only
those shards of the graph. The sharded brute-force top-k, the pod step
with replicated state, the pod step with the state split over the four
shards and the build's sharded symmetrization must equal the one-process
oracle (the port's single-device scan, engine and symmetrization on the
same inputs): ids, orders, scored sets and neighbor rows array-equal,
scores bit-equal. A rendezvous that does not finish within
the time limit fails the test.
"""

import os
import socket
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    pid, port = int(sys.argv[1]), sys.argv[2]

    import torch.distributed as dist
    from rad_tpu_torch.parallel.multihost import (initialize_multihost,
                                                  global_mesh)
    for _ in range(2):
        initialize_multihost(f"127.0.0.1:{port}", num_processes=2,
                             process_id=pid)
    assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
    mesh = global_mesh(local_devices=["cpu", "cpu"])
    assert mesh.size == 4 and mesh.shape == {"graph": 4}
    try:                          # no CUDA here: never a CPU fallback
        global_mesh()
        raise AssertionError("global_mesh() fell back to the CPU")
    except RuntimeError as exc:
        assert "no CUDA device" in str(exc), exc

    from rad_tpu_torch.build.reference import build_hnsw
    from rad_tpu_torch.fp.pack import (popcount_rows, random_fingerprints,
                                       to_torch_packed)
    from rad_tpu_torch.fp.tanimoto import bruteforce_topk, tanimoto_matrix
    from rad_tpu_torch.parallel.pod import _padded_device_graph
    from rad_tpu_torch.parallel.sharded import (
        init_state_sharded, make_sharded_step, make_sharded_step_full,
        shard_graph, sharded_bruteforce_topk,
        sharded_state_to_reference_arrays)
    from rad_tpu_torch.traverse import device as dev

    # the same library in every process (one seed)
    fps = random_fingerprints(256, n_bits=128, density=0.25, seed=13)
    graph = build_hnsw(fps, connectivity=4, expansion_add=16, seed=0)
    sg = shard_graph(graph, mesh)
    mine = [t is not None for t in sg.packed.shards]
    assert mine == [pid == 0, pid == 0, pid == 1, pid == 1], mine

    packed = to_torch_packed(np.asarray(graph.packed), "cpu")
    pops = popcount_rows(packed)
    queries = np.asarray(graph.packed)[:8]
    d, ids = sharded_bruteforce_topk(sg, queries, k=3, mesh=mesh)
    assert (d[:, 0] == 0).all() and ids[:, 0].tolist() == list(range(8))
    d1, i1 = bruteforce_topk(packed[:8], packed, 3)
    assert torch.equal(d, d1) and torch.equal(ids, i1)

    target, t_pop = packed[7], pops[7]
    n_top = graph.layer_sizes[graph.max_level]
    top = torch.arange(n_top, dtype=torch.int32)
    seeds = tanimoto_matrix(target[None, :], packed[:n_top])[0]
    dgl = dev.prepare_device_graph(graph, "cpu")
    oracle = dev.prime(dev.init_state(dgl, frontier_capacity=1 << 10,
                                      head_capacity=None), dgl, top, seeds)
    for _ in range(3):
        oracle = dev.fused_step(oracle, dgl, packed, pops, target, t_pop, 8)
    want = dev.state_to_reference_arrays(oracle)

    dg = sg.device_graph()
    st = dev.prime(dev.init_state(dg, frontier_capacity=1 << 10,
                                  head_capacity=None), dg, top, seeds)
    step = make_sharded_step(sg, mesh, batch=8)
    for _ in range(3):
        st = step(st, target, t_pop)
    got = dev.state_to_reference_arrays(st)
    for k in want:
        assert np.array_equal(got[k], want[k]), k

    full = dev.prime(init_state_sharded(sg, mesh, 1 << 10, len(graph)),
                     _padded_device_graph(sg), top, seeds)
    step = make_sharded_step_full(sg, mesh, batch=8)
    for _ in range(3):
        full = step(full, target, t_pop)
    got = sharded_state_to_reference_arrays(full)
    n = len(graph)
    for k in ("order_log", "n_scored", "n_dropped", "f_score", "f_row"):
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(got["scored"][:n], want["scored"])
    assert np.array_equal(got["scores"][:n], want["scores"])

    # the build's symmetrization across the processes (its all-to-all)
    from rad_tpu_torch.build.exact import _symmetrize
    from rad_tpu_torch.build.exact_sharded import symmetrize_sharded
    # real selections: distinct destinations, never self, each edge at
    # its symmetric pair distance (rows past 60 are padding)
    rng = np.random.default_rng(3)
    dist_ = rng.random((60, 60), dtype=np.float32)
    dist_ = np.minimum(dist_, dist_.T)
    sel_np = np.full((64, 4), -1, np.int32)
    d_np = np.full((64, 4), np.inf, np.float32)
    for i in range(60):
        o = rng.choice(59, size=4, replace=False)
        sel_np[i] = np.where(o >= i, o + 1, o)
        d_np[i] = dist_[i, sel_np[i]]
    sel, sel_d = torch.from_numpy(sel_np), torch.from_numpy(d_np)
    rows = symmetrize_sharded(
        [sel[s * 16:(s + 1) * 16] if m else None
         for s, m in enumerate(mine)],
        [sel_d[s * 16:(s + 1) * 16] if m else None
         for s, m in enumerate(mine)], 60, 6, mesh, "graph").full()
    assert torch.equal(rows, _symmetrize(sel, sel_d, 60, 6)), "symmetrize"
    print(f"proc {pid}: multihost ok ({int(oracle.n_scored)} scored)",
          flush=True)
    dist.destroy_process_group()
""")


def test_two_process_global_mesh(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "multihost ok" in out, out
