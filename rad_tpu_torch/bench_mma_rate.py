"""The 1-bit tensor-core product of the Tanimoto kernels, checked and rated.

Compiles ``probes/mma_rate.cu`` with ``nvcc`` (the flags of the kernel
library) into the build directory, runs it and prints its JSON lines: a
correctness check of the 1-bit ``wgmma`` body of ``csrc/tanimoto_mma.cuh``
on ragged tiles, then that instruction's measured rate in tera-operations
a second (2 * M * N * K an instruction, K in bits): the peak that the
kernels' bound by operations divides by. The card's name and power limit
come first.

    python -m rad_tpu_torch.bench_mma_rate
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from rad_tpu_torch import _cuda

_SOURCE = Path(__file__).resolve().parent / "probes" / "mma_rate.cu"


def main() -> int:
    out_dir = _cuda._build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = out_dir / "mma_rate"
    flags = [f for f in _cuda.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    build = subprocess.run([_cuda._nvcc(), *flags, "-o", str(exe),
                            str(_SOURCE)], capture_output=True, text=True)
    sys.stderr.write(build.stdout + build.stderr)
    if build.returncode != 0:
        return build.returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return subprocess.run([str(exe)]).returncode


if __name__ == "__main__":
    sys.exit(main())
