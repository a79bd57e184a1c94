"""Build a persisted HNSW index + SMILES database from a molecule file.

The command line of the repo's ``scripts/build_index.py`` on the port: one
command takes a delimited file of ``key<TAB>smiles`` (or ``smiles`` only;
keys default to line numbers) and produces ``<out>.npz`` (index) +
``<out>.db`` (SMILES sidecar), ready for
``python -m rad_tpu_torch.scripts.start_hnsw_server`` or local traversal.

Fingerprints are the deterministic hashed fingerprints of
:func:`rad_tpu_torch.fp.smiles_fingerprints`. ``--backend auto`` is the
exact builder on ``--device`` (default: the first CUDA device; ``cpu``
runs the kernels' plain twins).

    python -m rad_tpu_torch.scripts.build_index molecules.smi \\
        --out library --ndim 1024 --connectivity 16 --expansion-add 400
"""

from __future__ import annotations

import argparse
import logging
import sys
import time


def read_molecules(path: str, delimiter: str | None):
    keys, smiles = [], []
    with open(path) as f:
        for lineno, line in enumerate(f):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(delimiter) if delimiter else line.split()
            if len(parts) >= 2 and parts[0].lstrip("-").isdigit():
                keys.append(int(parts[0]))
                smiles.append(parts[1])
            else:
                keys.append(lineno)
                smiles.append(parts[0])
    return keys, smiles


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("molecules", help="file of 'key smiles' or 'smiles'")
    ap.add_argument("--out", required=True,
                    help="output prefix (-> <out>.npz + <out>.db)")
    ap.add_argument("--ndim", type=int, default=1024)
    ap.add_argument("--radius", type=int, default=2)
    ap.add_argument("--connectivity", type=int, default=16)
    ap.add_argument("--expansion-add", type=int, default=400)
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "native", "host", "device"])
    ap.add_argument("--device", default=None,
                    help="where the build runs (default: the first CUDA "
                         "device; 'cpu' for the kernels' plain twins)")
    ap.add_argument("--delimiter", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--debug", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format="%(asctime)s %(levelname)s: %(message)s")
    log = logging.getLogger("build_index")

    import numpy as np
    from rad_tpu_torch import HNSWIndex
    from rad_tpu_torch.fp import smiles_fingerprints
    from rad_tpu_torch.store import create_smiles_db

    keys, smiles = read_molecules(args.molecules, args.delimiter)
    log.info("read %d molecules from %s", len(keys), args.molecules)

    t0 = time.perf_counter()
    fps = smiles_fingerprints(smiles, n_bits=args.ndim, radius=args.radius)
    log.info("fingerprinted in %.2fs", time.perf_counter() - t0)

    index = HNSWIndex(ndim=args.ndim, connectivity=args.connectivity,
                      expansion_add=args.expansion_add,
                      backend=args.backend, seed=args.seed,
                      device=args.device)
    index.add(np.asarray(keys, np.int64), fps)
    t0 = time.perf_counter()
    index.build()
    log.info("built HNSW (max_level=%d) in %.2fs on %s", index.max_level,
             time.perf_counter() - t0, index.device)

    index.save(args.out + ".npz")
    n_rows = create_smiles_db(args.out + ".db", zip(keys, smiles))
    log.info("wrote %s.npz (%d nodes) and %s.db (%d rows)",
             args.out, len(index), args.out, n_rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
