"""The port's synthetic screening library against the recipe it copies
(``examples/enrichment_example.py:make_library_batched``), and the
profiling entry point's refusal to run without a CUDA device."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from rad_tpu_torch import profiling
from rad_tpu_torch.synthetic import make_library

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example_module():
    path = os.path.join(REPO, "examples", "enrichment_example.py")
    spec = importlib.util.spec_from_file_location("enrichment_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,n_bits,batch", [(4500, 256, 128),
                                            (300, 64, 1 << 16)])
def test_make_library_matches_example_recipe(n, n_bits, batch):
    ref_packed, ref_scores = _example_module().make_library_batched(
        n, n_bits=n_bits, seed=3, batch=batch)
    packed, scores = make_library(n, n_bits=n_bits, seed=3, batch=batch)
    assert packed.dtype == np.uint32 and packed.shape == (n, n_bits // 32)
    np.testing.assert_array_equal(packed, ref_packed)
    np.testing.assert_array_equal(scores, ref_scores)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA device")
def test_profiling_refuses_without_cuda(capsys):
    assert profiling.main() == 1
    assert "no CUDA device" in capsys.readouterr().err
