"""``parallel/ensemble.solve_equilibrium_batch`` over a mesh steps its
chunks in lockstep: every running chunk queues its iteration before the one
host read of all their masks, so the devices of a mesh work at the same
time, and a chunk whose elements have all stopped drops out (float64, 33^2).
"""

import torch

from scpn_fusion_tpu_torch.parallel import ensemble
from scpn_fusion_tpu_torch.parallel.ensemble import solve_equilibrium_batch
from scpn_fusion_tpu_torch.parallel.halo import make_z_mesh
from tests.test_torch_parallel_ensemble import F64, case


def test_mesh_chunks_step_in_lockstep(monkeypatch):
    """JAX's straggler pair, one element a shard: the chunks' iterations
    interleave while both run, and the chunk that finishes first drops out."""
    _, cfg, grid, base = case(max_iter=300)
    batch = torch.stack([base, base])
    i_t = torch.tensor([15.0, 2.0], dtype=F64)
    order = []
    step = ensemble._BatchPicard.step

    def recorded(self):
        order.append((id(self), self.k))
        return step(self)

    monkeypatch.setattr(ensemble._BatchPicard, "step", recorded)
    out = solve_equilibrium_batch(cfg, grid, batch, i_t,
                                  mesh=make_z_mesh(2, axis="batch", device="cpu"))
    n0, n1 = out.iterations.tolist()
    assert bool(out.converged.all()) and n0 != n1
    ids = list(dict.fromkeys(i for i, _ in order))
    assert len(ids) == 2 and len(order) == n0 + n1
    both = min(n0, n1)
    assert order[:2 * both] == [(ids[c], k) for k in range(both) for c in (0, 1)]
    later = 0 if n0 > n1 else 1
    assert order[2 * both:] == [(ids[later], k) for k in range(both, max(n0, n1))]
