"""Port parity: the IMAS IDS adapters (``io/imas_ids.py``).

``scpn_fusion_tpu_torch/io/imas_ids.py`` is a copy of the JAX package's
numpy-only module: it is held equal to its source text outside the import
lines.  Both seeds of ``fuzz/seeds/geqdsk`` (and a seeded small file) go
G-EQDSK -> ``equilibrium`` IDS -> G-EQDSK through either package with equal
results, the port's reader feeding the port; the transport-state IDS
writers give equal payloads on a seeded state; and both packages reject the
same malformed IDS with the same message.
"""

import dataclasses
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from torch_parity import rng

from scpn_fusion_tpu.io import geqdsk as jgq
from scpn_fusion_tpu.io import imas_ids as jids
from scpn_fusion_tpu_torch.io import geqdsk as tgq
from scpn_fusion_tpu_torch.io import imas_ids as tids

ROOT = Path(__file__).resolve().parent.parent
SEEDS = sorted((ROOT / "fuzz" / "seeds" / "geqdsk").glob("*.geqdsk"))


def _code_lines(path: Path) -> list[str]:
    return [line for line in path.read_text().splitlines()
            if not line.lstrip().startswith(("import ", "from "))]


def test_copy_equals_source_outside_imports():
    assert _code_lines(ROOT / "scpn_fusion_tpu_torch" / "io" / "imas_ids.py") == _code_lines(
        ROOT / "scpn_fusion_tpu" / "io" / "imas_ids.py")
    text = (ROOT / "scpn_fusion_tpu_torch" / "io" / "imas_ids.py").read_text()
    assert "jax" not in text.replace("jax arrays", "").replace("jnp", "")


def _assert_same(a, b):
    if isinstance(b, dict):
        assert a.keys() == b.keys()
        for k in b:
            _assert_same(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def _small():
    g = rng(2)
    kw = dict(description="case", nw=5, nh=4, rdim=4.0, zdim=3.0, rcentr=6.2, rleft=4.0,
              zmid=0.0, rmaxis=6.1, zmaxis=0.05, simag=-1.2, sibry=0.3, bcentr=5.3,
              current=1.5e7, fpol=g.random(5), pres=g.random(5), ffprime=g.random(5),
              pprime=g.random(5), qpsi=1.0 + g.random(5), psirz=g.random((4, 5)),
              rbdry=np.asarray([5.0, 7.0, 6.0]), zbdry=np.asarray([0.0, 0.5, 1.0]))
    return jgq.GEqdsk(**kw), tgq.GEqdsk(**kw)


@pytest.mark.parametrize("source", [*SEEDS, "small"], ids=lambda p: getattr(p, "stem", p))
def test_round_trip_matches_jax(source):
    if source == "small":
        ref_eq, eq = _small()
    else:
        ref_eq, eq = jgq.read_geqdsk(source), tgq.read_geqdsk(source)
    ref_ids = jids.geqdsk_to_equilibrium_ids(ref_eq, time_s=1.5, shot=7)
    ids = tids.geqdsk_to_equilibrium_ids(eq, time_s=1.5, shot=7)
    _assert_same(ids, ref_ids)
    ref_back, back = jids.equilibrium_ids_to_geqdsk(ref_ids), tids.equilibrium_ids_to_geqdsk(ids)
    assert isinstance(back, tgq.GEqdsk)
    for f in dataclasses.fields(ref_back):
        _assert_same(getattr(back, f.name), getattr(ref_back, f.name))


def test_transport_writers_match_jax():
    g = rng(3)
    nr = 11
    state = SimpleNamespace(**{k: g.random(nr) for k in ("te", "ti", "ne", "n_d", "n_t", "n_he",
                                                         "chi_i", "chi_e", "d_n", "q")},
                            z_eff=1.7)
    params = SimpleNamespace(rho=lambda dt: np.linspace(0.0, 1.0, nr, dtype=dt), ip_ma=15.0,
                             b0=5.3, r0=6.2, nr=nr)
    for name in ("transport_state_to_core_profiles", "transport_state_to_core_transport"):
        _assert_same(getattr(tids, name)(state, params, time_s=2.0),
                     getattr(jids, name)(state, params, time_s=2.0))
    _assert_same(tids.transport_state_to_summary(state, params, p_aux_mw=33.0),
                 jids.transport_state_to_summary(state, params, p_aux_mw=33.0))


def test_validation_rejects_like_jax():
    ref_eq, eq = _small()
    for mod, e in ((jids, ref_eq), (tids, eq)):
        ids = mod.geqdsk_to_equilibrium_ids(e)
        ids["time_slice"][0]["profiles_2d"][0]["psi"] = [[1.0, 2.0]]
        with pytest.raises(mod.ImasIdsError, match="row count"):
            mod.validate_equilibrium_ids(ids)
        with pytest.raises(mod.ImasIdsError, match="missing keys"):
            mod.validate_equilibrium_ids({"time": [0.0]})
