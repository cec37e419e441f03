"""``parallel/sharded_fb.py`` of the port on 4 and 8 CPU shards against the
port's single-device free-boundary forward (outer iterations equal, 1e-8
span-relative, the bars of ``tests/test_sharded_fb.py``) and each other
(1e-10).  The case is ``tests/test_torch_parallel_fb.py``'s.
"""

import pytest

from tests.test_torch_parallel_fb import fb_case, span_dev

SHARDS = (4, 8)


@pytest.fixture(scope="module")
def case():
    return fb_case(SHARDS)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_fb_matches_single_device(n_shards, case):
    _, _, single, sharded = case
    res = sharded[n_shards]
    assert res.converged
    assert res.outer_iterations == single.outer_iterations
    assert span_dev(res.psi, single.psi) < 1e-8


def test_sharded_fb_shard_count_invariance(case):
    _, _, _, sharded = case
    assert span_dev(sharded[8].psi, sharded[4].psi) < 1e-10
