"""The port's CUDA kernels against their plain versions, on the card.

Imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

On a machine without a CUDA card every test here skips.
"""

import numpy as np
import pytest
import torch

from kinematic_icp_tpu_torch.ops import gn, hashmap
from kinematic_icp_tpu_torch.ops.points import P3, transform

SOLVE = dict(voxel_size=1.0, max_num_iterations=10,
             convergence_criterion=0.001, use_adaptive_regularization=True,
             fixed_regularization=0.0, max_range=60.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _problem(dev, v, n=512, nmap=3000, seed=0):
    rng = np.random.default_rng(seed)
    map_pts = rng.uniform(-20, 20, (nmap, 3)).astype(np.float32)
    src = (map_pts[:n] + rng.normal(0, 0.05, (n, 3))).astype(np.float32)
    mask = torch.from_numpy(rng.uniform(size=n) < 0.9).to(dev)
    m = hashmap.insert(hashmap.empty(1 << 13, 20, device=dev),
                       P3.from_array(torch.from_numpy(map_pts).to(dev)),
                       torch.ones(nmap, dtype=torch.bool, device=dev), 1.0, 4)
    source = P3.from_array(torch.from_numpy(src).to(dev))
    c, s = np.cos(0.01), np.sin(0.01)
    guess = torch.tensor([[c, -s, 0, 0.02], [s, c, 0, -0.01], [0, 0, 1, 0],
                          [0, 0, 0, 1]], dtype=torch.float32, device=dev)
    cand = hashmap.gather_candidates(m, transform(guess, source), 1.0, 4, v)
    return cand, source, mask, guess


@pytest.mark.cuda
@pytest.mark.parametrize("v,crossing", [(10, False), (27, True)])
def test_gn_kernel_matches_plain(card, v, crossing):
    cand, source, mask, guess = _problem(card, v)
    before = gn.LAUNCHES
    k = gn.gn_solve(cand, source, mask, guess, 0.5, check_crossing=crossing,
                    **SOLVE)
    assert gn.LAUNCHES == before + 1
    p = gn.gn_solve(cand, source, mask, guess, 0.5, check_crossing=crossing,
                    backend="torch", **SOLVE)
    torch.cuda.synchronize()
    assert gn.LAUNCHES == before + 1
    # same per-element rounding (-fmad=false); sums in another order
    np.testing.assert_allclose(k[0].cpu().numpy(), p[0].cpu().numpy(),
                               atol=1e-5, rtol=0)
    for i in (1, 2, 4):
        assert int(k[i]) == int(p[i])
    assert int(k[2]) > 100


@pytest.mark.cuda
def test_gn_kernel_rejects_bad_input(card):
    cand, source, mask, guess = _problem(card, 10, n=64, nmap=300)
    with pytest.raises(ValueError):
        gn.gn_solve(cand, source, mask, guess.double(), 0.5, **SOLVE)
    with pytest.raises(ValueError):
        gn.gn_solve(cand._replace(words=cand.words.transpose(1, 2)), source,
                    mask, guess, 0.5, **SOLVE)
